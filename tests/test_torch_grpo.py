"""The port's GRPO slice against the JAX package: the rewards, the repeat
sampler, `GRPOConfig`, `per_token_logps`, the trainer's update, buffers,
accumulation, reference policy and TR-DPO sync, save / restore, the SFT
checkpoint hand-off and the `reason` CLI.

Tiny configs in fp32 on the CPU (frozen weights stored in bf16 on both
sides, as both trainers store them); one fixed rollout buffer, made from a
seed with numpy, fed to both trainers' updates (torch's draws differ from
jax.random's, so sampled rollouts are never compared). Parameters go from
the JAX trainer to the port through `from_jax_params`; the JAX calls are
compiled with `jax.jit`."""

import copy
import dataclasses
import functools
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bioreason_tpu import config as JC
from bioreason_tpu.data.nt_tokenizer import KmerTokenizer as JKmer
from bioreason_tpu.data.processor import BioProcessor as JProc
from bioreason_tpu.data.text_tokenizer import ByteTextTokenizer as JByte
from bioreason_tpu.models.fusion import init_fusion as j_init
from bioreason_tpu.parallel import make_mesh
from bioreason_tpu.train import dataflow as JDF
from bioreason_tpu.train import grpo as JG
from bioreason_tpu.train import rewards as JR
from bioreason_tpu_torch import config as TC
from bioreason_tpu_torch.data import BioProcessor, ByteTextTokenizer, KmerTokenizer
from bioreason_tpu_torch.data import kegg as TK
from bioreason_tpu_torch.data.chat_template import apply_chat_template
from bioreason_tpu_torch.train import dataflow as TDF
from bioreason_tpu_torch.train import grpo as TG
from bioreason_tpu_torch.train import lora as TL
from bioreason_tpu_torch.train import rewards as TR
from bioreason_tpu_torch.weights import from_jax_params

# one intra-op thread: the tensors here are tiny, and pytest-xdist runs
# several workers on the host's cores, which torch's default of a thread
# per core oversubscribes many times over
torch.set_num_threads(1)

TOK = ByteTextTokenizer()
PROC = BioProcessor(TOK, KmerTokenizer())
JPROC = JProc(JByte(), JKmer())
G, CLEN = 2, 6


def t(x):
    return torch.from_numpy(np.asarray(x))


def indexed_reward(prompts, completions, **kw):
    """A reward set by the row, so that both trainers score alike whatever
    they sample: groups of 2 get (0, 1), (2, 2), ..."""
    return [float((i * 7) % 3) for i in range(len(completions))]


# -- rewards, repeat sampler, config -----------------------------------------

COMPLETIONS = ["<think>\nhm\n</think>\nAnswer: p53 pathway\n", "<think>x</think> wnt",
               "no tags at all", "<think>\na\n</think>\n</think>\nMAPK", "</think>P53",
               "<think>\n\n</think>\n\n", "</think> one two three four five", ""]
ANSWERS = ["p53", "wnt", "mapk", "mapk", "p53", "x", "four", "y"]


@pytest.mark.parametrize("name", sorted(JR.REWARD_REGISTRY))
def test_reward_functions_match(name):
    assert sorted(TR.REWARD_REGISTRY) == sorted(JR.REWARD_REGISTRY)
    got = TR.REWARD_REGISTRY[name]([""] * 8, COMPLETIONS, answer=ANSWERS, kegg_id=["k"] * 8)
    assert got == JR.REWARD_REGISTRY[name]([""] * 8, COMPLETIONS, answer=ANSWERS,
                                           kegg_id=["k"] * 8)
    assert [f.__name__ for f in TR.get_reward_funcs([name])] == [
        f.__name__ for f in JR.get_reward_funcs([name])]
    for c in COMPLETIONS:
        assert TR._count_xml(c) == JR._count_xml(c)
    # correctness is per example, not against the first answer's characters
    assert TR.correctness_reward([], ["</think>p53", "</think>wnt"], ["p53", "p53"]) == [2.0, 0.0]


@pytest.mark.parametrize("seed,epoch,n,per_step", [(0, 0, 10, 3), (1, 2, 7, 2), (42, 1, 64, 4)])
def test_repeat_random_indices_match(seed, epoch, n, per_step):
    got = list(TDF.repeat_random_indices(n, per_step, G, seed, epoch))
    assert got == list(JDF.repeat_random_indices(n, per_step, G, seed, epoch))
    assert all(len(s) == per_step * G and len(set(s[::G])) == per_step for s in got)


def test_grpo_config_matches_and_refuses_later_slices():
    assert ([f.name for f in dataclasses.fields(TC.GRPOConfig)]
            == [f.name for f in dataclasses.fields(JC.GRPOConfig)])
    assert dataclasses.asdict(TC.GRPOConfig()) == dataclasses.asdict(JC.GRPOConfig())
    # the int8 rollouts and QLoRA are ported: the configs construct, as JAX's
    for kw in ({"rollout_int8": True}, {"rollout_kv_int8": True}, {"frozen_dtype": "int8"},
               {"frozen_dtype": "int8", "rollout_int8": True, "rollout_kv_int8": True}):
        assert dataclasses.asdict(TC.GRPOConfig(**kw)) == dataclasses.asdict(
            JC.GRPOConfig(**kw))


# -- the fixed rollout buffer and the two trainers ----------------------------

def fusion_cfgs(**dec_kw):
    """JAX and port tiny configs, decoder head dim 64 (one the kernel takes)."""
    dec_kw = {"head_dim": 64, **dec_kw}
    jcfg = JC.FusionConfig.tiny(text_vocab=TOK.vocab_size, dna_pad_token_id=TOK.dna_pad_id)
    tcfg = TC.FusionConfig.tiny(text_vocab=TOK.vocab_size, dna_pad_token_id=TOK.dna_pad_id)
    jcfg = dataclasses.replace(jcfg, decoder=dataclasses.replace(jcfg.decoder, **dec_kw),
                               max_length_dna=64)
    tcfg = dataclasses.replace(tcfg, decoder=dataclasses.replace(tcfg.decoder, **dec_kw),
                               max_length_dna=64)
    return jcfg, tcfg


def grpo_cfgs(**kw):
    """(port, JAX) GRPOConfigs of the same values; AdamW eps 1e-3 on both
    sides (see test_torch_train.test_trainer_two_steps_match_jax)."""
    def make(C):
        return C.GRPOConfig(**{
            "num_generations": G, "batch_size": 4, "max_completion_length": CLEN,
            "sampling": C.SamplingConfig(temperature=1.0, top_k=10, top_p=0.95,
                                         max_new_tokens=CLEN),
            "optim": C.OptimConfig(learning_rate=1e-2, total_steps=20, warmup_ratio=0.0,
                                   eps=1e-3),
            "lora": C.LoRAConfig(r=4, alpha=8, dropout=0.0), **kw})
    return make(TC), make(JC)


def prompt_items(n_prompts, seed=0):
    raw = [TK.format_kegg_prompt_only(it)
           for it in TK.synthetic_kegg_items(n_prompts, seq_len=24, seed=seed)]
    return [x for x in raw for _ in range(G)]


@functools.lru_cache(maxsize=None)
def jax_params():
    jcfg, _ = fusion_cfgs()
    return jax.jit(j_init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)


def jax_trainer(**kw):
    jcfg, _ = fusion_cfgs()
    _, jg = grpo_cfgs(**kw)
    return JG.GRPOTrainer(jcfg, jg, JPROC, [indexed_reward, JR.correctness_reward],
                          mesh=make_mesh(JC.MeshConfig(data=1), devices=jax.devices()[:1]),
                          params=jax_params())


def port_trainer(init, impl="xla", **kw):
    _, tcfg = fusion_cfgs(attention_impl=impl)
    tg, _ = grpo_cfgs(**kw)
    return TG.GRPOTrainer(tcfg, tg, PROC, [indexed_reward, TR.correctness_reward],
                          model=from_jax_params(init, tcfg, device="cpu"), device="cpu")


@functools.lru_cache(maxsize=None)
def fixed_buffer():
    """2 prompts x G: the processor's left-padded prompts, regrouped by
    `_repeat_prompt_batch`, then CLEN random completion tokens (the last row
    ends early at EOS) and random advantages."""
    unique = prompt_items(2)[::G]
    out = PROC([apply_chat_template(ex)["prompt"] for ex in unique],
               [ex["dna_sequences"] for ex in unique], max_length_dna=64, padding_side="left")
    rep = TG._repeat_prompt_batch(out, G)
    rng = np.random.default_rng(11)
    comp = rng.integers(3, 256, (2 * G, CLEN)).astype(np.int32)
    cmask = np.ones((2 * G, CLEN), np.int32)
    comp[-1, 3] = TOK.eos_token_id
    cmask[-1, 4:] = 0
    comp[-1, 4:] = TOK.eos_token_id
    return {"full_ids": np.concatenate([rep.input_ids, comp], 1),
            "full_mask": np.concatenate([rep.attention_mask, cmask], 1),
            "completion_mask": cmask, "dna_input_ids": rep.dna_input_ids,
            "dna_attention_mask": rep.dna_attention_mask,
            "advantages": rng.standard_normal(2 * G).astype(np.float32)}


def test_repeat_prompt_batch_matches():
    unique = prompt_items(3)[::G]
    out = PROC([apply_chat_template(ex)["prompt"] for ex in unique],
               [ex["dna_sequences"] for ex in unique], max_length_dna=64, padding_side="left")
    a, b = TG._repeat_prompt_batch(out, 3), JG._repeat_prompt_batch(out, 3)
    for key in ("input_ids", "attention_mask", "dna_input_ids", "dna_attention_mask"):
        np.testing.assert_array_equal(getattr(a, key), getattr(b, key))
    assert a.batch_idx_map == b.batch_idx_map


def jax_logps(params, buf):
    jcfg, _ = fusion_cfgs()
    fn = jax.jit(JG.per_token_logps, static_argnames=("cfg", "completion_len"))
    return np.asarray(fn(params, jcfg, buf["full_ids"], buf["full_mask"], buf["dna_input_ids"],
                         buf["dna_attention_mask"], completion_len=CLEN))


def fed(trainer, batch):
    """Make `step` train on `batch` instead of rolling out."""
    trainer._generate_and_score = lambda items: {
        "batch": batch, "completion_len": CLEN, "metrics": {}, "completions": [],
        "prompts": [], "rewards": []}
    return trainer


# case -> GRPOConfig fields. "kl": beta > 0 with epsilon_high and a TR-DPO
# sync after the second step; "mu2": num_iterations 2 on stored old logps
CASES = {"kl": dict(beta=0.04, epsilon_high=0.28, sync_ref_model=True, ref_model_sync_steps=2),
         "mu2": dict(beta=0.0, epsilon_high=0.28, num_iterations=2)}


@functools.lru_cache(maxsize=None)
def jax_run(case):
    """The JAX trainer's two steps on the fixed buffer: its initial
    parameters, the buffer with the ref / old logps, each step's metrics,
    the final parameters and (case "kl") the synced reference's parameters
    and logps."""
    tr = jax_trainer(**CASES[case])
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
    final = jax.tree.map(np.asarray, tr.params)
    ref = None
    if tr.cfg.beta > 0.0:
        ref = (flat_leaves(jax.tree.map(np.asarray, tr._ref_params)),
               jax_logps(tr._ref_params, buf))
    return init, buf, metrics, final, ref


def flat_leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def jax_leaf(jf, name):
    """The JAX leaf of the port parameter `name` (see test_torch_train)."""
    parts = name.split(".")
    if len(parts) > 2 and parts[1] == "layers":
        path, i = f"{parts[0]}/layers/{'/'.join(parts[3:-1])}", int(parts[2])
    else:
        path, i = "/".join(parts[:-1]), None
    leaf = parts[-1]
    key = ("embedding" if path.endswith("embed") else "kernel") if leaf == "weight" else leaf
    ref = jf[f"{path}/{key}"]
    ref = ref if i is None else ref[i]
    return ref.T if key == "kernel" else ref


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_update_two_steps_match_jax(case, impl):
    """Two steps of each trainer on the fixed buffer: loss, kl, clip_ratio
    and grad_norm at rel 1e-5; LoRA and projection leaves at atol 1e-5. The
    port's decoder takes the grouped einsums ('xla') or the flash route's
    plain versions ('pallas'); they differ from the JAX 'xla' only on fully
    masked left-pad rows, which no completion position reads.

    Case "kl" then holds the TR-DPO-synced reference: its fp32 leaves at
    atol 1e-5; its bf16 weights, a * merged policy + (1 - a) * ref in bf16
    arithmetic, equal but for a few elements per 10^4 and those within one
    bf16 ulp of the tensor's largest magnitude (2^-8 of it): the merged
    adapters agree at ~1e-7, not bitwise, so a product near a rounding
    boundary may round the other way; its logps at atol 1e-4, the effect of
    such a flip."""
    init, buf, jmetrics, jfinal, jref = jax_run(case)
    trainer = fed(port_trainer(init, impl, **CASES[case]),
                  {k: t(v) for k, v in buf.items()})
    assert trainer.names == [n for n in trainer.names
                             if n.endswith(("lora_a", "lora_b")) or n.startswith("dna_projection")]
    for jm in jmetrics:
        m = trainer.step([])
        for key in ("loss", "kl", "clip_ratio", "grad_norm"):
            assert math.isfinite(m[key])
            assert m[key] == pytest.approx(jm[key], rel=1e-5, abs=1e-7), key
    if case == "mu2":
        assert jmetrics[1]["clip_ratio"] > 0
    jf = flat_leaves(jfinal)
    for name, p in trainer.trainable_state().items():
        np.testing.assert_allclose(p.detach().numpy(), jax_leaf(jf, name), atol=1e-5, rtol=0,
                                   err_msg=name)
    if jref is not None:
        jtree, jlogps = jref
        flipped = total = 0
        for name, p in trainer.ref_model.named_parameters():
            got, want = p.detach().float().numpy(), np.asarray(jax_leaf(jtree, name), np.float32)
            if p.dtype == torch.float32:
                np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=name)
            else:
                np.testing.assert_allclose(got, want, atol=2 ** -8 * np.abs(want).max(),
                                           rtol=0, err_msg=name)
                flipped, total = flipped + int((got != want).sum()), total + got.size
        assert flipped <= 1e-3 * total, (flipped, total)
        with torch.no_grad():
            ref = TG.per_token_logps(trainer.ref_model, trainer.fusion_cfg,
                                     *(t(buf[k]) for k in ("full_ids", "full_mask",
                                                           "dna_input_ids",
                                                           "dna_attention_mask")), CLEN)
        np.testing.assert_allclose(ref.numpy(), jlogps, atol=1e-4, rtol=0)
        # after the sync the reference holds weights of its own
        policy = dict(trainer.model.named_parameters())
        assert all(p.data_ptr() != policy[n].data_ptr()
                   for n, p in trainer.ref_model.named_parameters())


def test_per_token_logps_and_gradient_match():
    """Logps at atol 1e-5 and the gradients of a weighted sum of them with
    respect to the projection and an adapter, adapters active (B != 0)."""
    jcfg, tcfg = fusion_cfgs()
    init = jax_run("kl")[0]
    rng = np.random.default_rng(5)
    tree = jax.tree_util.tree_map_with_path(
        lambda p, x: (x + rng.standard_normal(x.shape).astype(np.float32) * 0.05
                      if "lora_b" in jax.tree_util.keystr(p) else x), init)
    buf = fixed_buffer()
    w = rng.standard_normal((2 * G, CLEN)).astype(np.float32)
    args = tuple(buf[k] for k in ("full_ids", "full_mask", "dna_input_ids", "dna_attention_mask"))

    @jax.jit
    def jfn(params):
        lp = JG.per_token_logps(params, jcfg, *args, completion_len=CLEN)
        return (lp * w).sum(), lp
    (_, jlp), jgrad = jax.value_and_grad(jfn, has_aux=True)(tree)
    model = from_jax_params(tree, tcfg, device="cpu")
    lp = TG.per_token_logps(model, tcfg, *(t(a) for a in args), CLEN)
    (lp * t(w)).sum().backward()
    np.testing.assert_allclose(lp.detach().numpy(), np.asarray(jlp), atol=1e-5, rtol=0)
    np.testing.assert_allclose(model.dna_projection.weight.grad.numpy(),
                               np.asarray(jgrad["dna_projection"]["kernel"]).T, atol=1e-5, rtol=0)
    np.testing.assert_allclose(model.decoder.layers[1].attn.v.lora_b.grad.numpy(),
                               np.asarray(jgrad["decoder"]["layers"]["attn"]["v"]["lora_b"][1]),
                               atol=1e-5, rtol=0)


def test_advantages_match_jax():
    """The same rewards give the same group advantages (population std, as
    numpy's default ddof 0), and every reward metric."""
    items = prompt_items(2)
    jout = jax_trainer(beta=0.0)._generate_and_score(items)
    trainer = port_trainer(jax_run("kl")[0], beta=0.0)
    out = trainer._generate_and_score(items)
    adv = out["batch"]["advantages"].numpy()
    np.testing.assert_allclose(adv, np.asarray(jout["batch"]["advantages"]), rtol=1e-6, atol=0)
    r = np.asarray(out["rewards"], np.float32).reshape(-1, G)
    assert not np.allclose(r.std(1), r.std(1, ddof=1))
    np.testing.assert_allclose(adv.reshape(-1, G).sum(1), 0.0, atol=1e-5)
    for key, v in jout["metrics"].items():
        assert out["metrics"][key] == pytest.approx(v, rel=1e-6), key
    assert out["batch"]["full_ids"].shape == (2 * G, out["batch"]["full_ids"].shape[1])
    assert out["metrics"]["nonfinite_rows"] == 0
    assert out["batch"]["completion_mask"].shape[1] == out["completion_len"] == CLEN


# -- the port's trainer on its own --------------------------------------------------

def test_step_runs_and_mu_buffering_reuses_the_rollout():
    trainer = port_trainer(jax_run("kl")[0], beta=0.04, num_iterations=2)
    items = prompt_items(2)
    before = {n: p.detach().clone() for n, p in trainer.trainable_state().items()}
    m = trainer.step(items)
    for key in ("loss", "kl", "clip_ratio", "grad_norm", "reward", "reward_std",
                "completion_length", "rewards/indexed_reward", "nonfinite_rows"):
        assert key in m and math.isfinite(m[key]), key
    buf = trainer._buffers[0]
    assert "old_logps" in buf["batch"] and "ref_logps" in buf["batch"]
    trainer.step(items)                  # mu = 2: the second step reuses the buffer
    assert trainer._buffers[0] is buf
    trainer.step(items)                  # the third one rolls out again
    assert trainer._buffers[0] is not buf
    assert len(trainer.last_completions) == len(items) == len(trainer.last_rewards)
    lora_b = [n for n in before if n.endswith("lora_b")]
    assert any(not torch.equal(trainer.trainable_state()[n].detach(), before[n]) for n in lora_b)


def accum_batch(rng, b, t_len):
    return {"full_ids": t(rng.integers(3, TOK.vocab_size - 10, (b, t_len)).astype(np.int32)),
            "full_mask": t(np.ones((b, t_len), np.int32)),
            "completion_mask": t(np.ones((b, CLEN), np.int32)),
            "advantages": t(rng.standard_normal(b).astype(np.float32))}


def test_accumulation_matches_the_big_batch():
    """grad_accum_steps=2 over two micro-batches of 4 moves the parameters
    as one step over the batch of 8 (mirrors tests/test_grpo.py:303); the
    first micro-step moves none."""
    init = jax_run("kl")[0]
    rng = np.random.default_rng(0)
    b1, b2 = accum_batch(rng, 4, 32), accum_batch(rng, 4, 32)
    big = {k: torch.cat([b1[k], b2[k]]) for k in b1}
    ta = port_trainer(init, beta=0.0, grad_accum_steps=2)
    tb = port_trainer(init, beta=0.0, batch_size=8)
    before = [p.detach().clone() for p in ta.params]
    ta._update(b1, CLEN)
    assert all(torch.equal(p, q) for p, q in zip(ta.params, before))
    ta._update(b2, CLEN)
    tb._update(big, CLEN)
    for p, q in zip(ta.params, tb.params):
        torch.testing.assert_close(p, q, rtol=2e-5, atol=2e-6)


def test_reference_policy_shares_the_frozen_tensors():
    """The reference holds the policy's frozen tensors themselves, no
    adapter, and a copy of the initial projection that the update leaves
    where it was; its logps are the adapter-off policy's."""
    trainer = port_trainer(jax_run("kl")[0], beta=0.04)
    ref, policy = trainer.ref_model, dict(trainer.model.named_parameters())
    assert not TL.has_lora(ref)
    names = [n for n, _ in ref.named_parameters()]
    assert names == [n for n in policy if ".lora_" not in n]
    for n, p in ref.named_parameters():
        if policy[n].requires_grad:
            assert n.startswith("dna_projection") and p.data_ptr() != policy[n].data_ptr()
        else:
            assert p.data_ptr() == policy[n].data_ptr(), n
    proj0 = ref.dna_projection.weight.detach().clone()
    buf = {k: t(v) for k, v in fixed_buffer().items()}
    buf["ref_logps"] = torch.zeros((2 * G, CLEN))
    trainer._update(buf, CLEN)
    assert not torch.equal(trainer.model.dna_projection.weight.detach(), proj0)
    assert torch.equal(ref.dna_projection.weight, proj0)
    stripped = TL.strip_lora(copy.deepcopy(trainer.model))
    with torch.no_grad():
        stripped.dna_projection.weight.copy_(proj0)
        stripped.dna_projection.bias.copy_(ref.dna_projection.bias)
        args = (trainer.fusion_cfg, buf["full_ids"], buf["full_mask"], buf["dna_input_ids"],
                buf["dna_attention_mask"], CLEN)
        torch.testing.assert_close(TG.per_token_logps(ref, *args),
                                   TG.per_token_logps(stripped, *args), atol=0, rtol=0)


def test_save_and_restore_round_trip(tmp_path):
    init = jax_run("kl")[0]
    trainer = port_trainer(init, beta=0.04)
    trainer.step(prompt_items(2))
    trainer.save(str(tmp_path / "s"), {"note": 1})
    saved = {n: p.detach().clone() for n, p in trainer.trainable_state().items()}
    other = port_trainer(init, beta=0.04).restore(str(tmp_path / "s"))
    assert other.step_count == 1 and other.opt.count == trainer.opt.count
    for n, p in other.trainable_state().items():
        assert torch.equal(p.detach(), saved[n]), n
    # the reference is rebuilt from the restored trainable leaves
    assert torch.equal(other.ref_model.dna_projection.weight, saved["dna_projection.weight"])
    from bioreason_tpu_torch.train.checkpoint import load_checkpoint
    assert load_checkpoint(str(tmp_path / "s"))["metadata"] == {"stage": "grpo", "note": 1}


def test_trainer_refuses_bad_arguments():
    _, tcfg = fusion_cfgs()
    tg, _ = grpo_cfgs()
    with pytest.raises(ValueError, match="divisible"):
        TG.GRPOTrainer(tcfg, dataclasses.replace(tg, num_generations=3), PROC,
                       [indexed_reward], device="cpu")
    trainer = TG.GRPOTrainer(tcfg, dataclasses.replace(tg, max_prompt_length=40), PROC,
                             [indexed_reward], device="cpu")
    with pytest.raises(ValueError, match="DNA features"):      # the cut drops placeholders
        trainer._prepare_prompts(prompt_items(2)[::G])


# -- the SFT hand-off and the CLI --------------------------------------------------

@pytest.fixture(scope="module")
def sft_final(tmp_path_factory):
    """A port `sft_final` of 2 tiny SFT steps (seed 3), and its trainer."""
    from bioreason_tpu_torch.cli import train_sft
    root = str(tmp_path_factory.mktemp("sft"))
    trainer = train_sft.main(["--decoder", "tiny", "--encoder", "tiny", "--device", "cpu",
                              "--max_steps", "2", "--max_length_dna", "64", "--n_synthetic",
                              "16", "--batch_size", "2", "--seed", "3", "--learning_rate",
                              "1e-2", "--checkpoint_dir", root])
    return os.path.join(root, "sft_final"), trainer


def test_load_sft_model_rebuilds_the_sft_model(sft_final):
    """Every parameter of the rebuilt SFT model equals the SFT trainer's,
    dtype included; `load_sft_for_grpo` merges its adapters (the function
    kept to the frozen dtype's rounding) and attaches fresh ones (B = 0)."""
    from bioreason_tpu_torch.train.checkpoint import load_sft_for_grpo, load_sft_model
    path, sft = sft_final
    cfg = sft.fusion_cfg
    model = load_sft_model(path, cfg, 3, "tiny", "tiny", device="cpu")
    want = dict(sft.model.named_parameters())
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(want)
    for name, p in got.items():
        assert p.dtype == want[name].dtype and torch.equal(p, want[name]), name
    grpo = load_sft_for_grpo(path, cfg, TC.LoRAConfig(r=4, alpha=8), 3, "tiny", "tiny",
                             device="cpu", generator=torch.Generator().manual_seed(0))
    assert TL.has_lora(grpo) and grpo.decoder.layers[0].attn.q.lora_a.shape[1] == 4
    assert not any(p.any() for n, p in grpo.named_parameters() if n.endswith("lora_b"))
    merged = TL.merged_weight(sft.model.decoder.layers[1].mlp.up)
    assert torch.equal(grpo.decoder.layers[1].mlp.up.weight, merged)


@pytest.mark.parametrize("flags,ok", [
    ([], True),
    (["--seed", "4"], False),
    (["--decoder", "qwen3-0.6b"], False),
    (["--dna_attention", "local:16"], False),
])
def test_reason_cli_from_an_sft_final(tmp_path, sft_final, flags, ok):
    """`reason --sft_checkpoint` runs 2 steps from the port's sft_final of
    the same seed and presets, and refuses another seed, preset or DNA
    attention before building anything."""
    from bioreason_tpu_torch.cli import reason
    path, _ = sft_final
    argv = ["--decoder", "tiny", "--encoder", "tiny", "--device", "cpu", "--seed", "3",
            "--num_generations", "2", "--batch_size", "4", "--max_steps", "2",
            "--max_completion_length", "8", "--max_length_dna", "64", "--n_synthetic", "16",
            "--sft_checkpoint", path, "--checkpoint_dir", str(tmp_path / "ck"),
            "--log_dir", str(tmp_path / "logs"), "--save_every", "1",
            "--use_vllm", "true"] + flags
    if not ok:
        with pytest.raises(ValueError, match="another base"):
            reason.main(argv)
        return
    trainer = reason.main(argv)
    assert trainer.step_count == 2 and len(trainer.metrics_history) == 2
    assert all(math.isfinite(m["loss"]) and math.isfinite(m["reward"])
               for m in trainer.metrics_history)
    assert (tmp_path / "ck" / "grpo_final" / "state.pt").exists()
    assert len((tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()) == 4
    resumed = reason.main(argv + ["--resume", "--max_steps", "1"])
    assert resumed.step_count == 3


def test_an_sft_final_without_the_base_keys_is_refused(tmp_path):
    """A checkpoint that does not record the seed (as the port wrote before
    it did) cannot pair its adapters with the right base: refused."""
    from bioreason_tpu_torch.train.checkpoint import load_sft_for_grpo, save_checkpoint
    _, tcfg = fusion_cfgs()
    save_checkpoint(str(tmp_path), {}, {}, 2, {"decoder": "tiny", "encoder": "tiny"})
    with pytest.raises(ValueError, match="seed"):
        load_sft_for_grpo(str(tmp_path), tcfg, None, 0, "tiny", "tiny", device="cpu")


@pytest.mark.parametrize("flag", ["--mesh=1,1,1",
                                  "--cpu_devices=2", "--wandb"])
def test_reason_cli_refuses_later_slices(flag, tmp_path):
    """--wandb is still refused. --mesh and --cpu_devices are ported
    (parallel/): each runs one finite GRPO step (a world of one rank, two
    spawned gloo ranks over 'data')."""
    from bioreason_tpu_torch.cli import reason
    argv = ["--decoder", "tiny", "--encoder", "tiny", "--device", "cpu", flag]
    if flag == "--wandb":
        with pytest.raises(NotImplementedError):
            reason.main(argv)
        return
    out = reason.main(argv + ["--seed", "3", "--num_generations", "2", "--batch_size", "4",
                              "--max_steps", "1", "--max_completion_length", "4",
                              "--max_length_dna", "64", "--n_synthetic", "16",
                              "--checkpoint_dir", str(tmp_path / "ck"),
                              "--log_dir", str(tmp_path / "logs")])
    assert len(out.metrics_history) == 1 and math.isfinite(out.metrics_history[0]["loss"])


def test_reason_cli_debug_nans_raises_at_a_planted_nan(tmp_path, monkeypatch):
    """`reason --debug_nans` (ported; was refused): a sound run steps as
    without it; with a NaN planted in every rmsnorm the rollout's prefill
    raises FloatingPointError naming the op that made it."""
    from bioreason_tpu_torch.cli import reason
    from bioreason_tpu_torch.models import layers as TLayers
    argv = ["--decoder", "tiny", "--encoder", "tiny", "--device", "cpu", "--seed", "3",
            "--num_generations", "2", "--batch_size", "2", "--max_steps", "1",
            "--max_completion_length", "4", "--max_length_dna", "64", "--n_synthetic", "16",
            "--checkpoint_dir", str(tmp_path / "ck"), "--log_dir", str(tmp_path / "logs")]
    sound = reason.main(argv + ["--debug_nans"])
    assert sound.metrics_history[0]["loss"] == reason.main(argv).metrics_history[0]["loss"]
    real = TLayers.rmsnorm
    monkeypatch.setattr(TLayers, "rmsnorm", lambda *a, **kw: real(*a, **kw) * float("nan"))
    with pytest.raises(FloatingPointError, match="aten.mul"):
        reason.main(argv + ["--debug_nans"])
