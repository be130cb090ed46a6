"""QLoRA and int8 rollouts in the port against the JAX package: int8 frozen
towers in SFT and GRPO training (`frozen_dtype="int8"`), the int8 dense's
backward, the rollout policy of `rollout_int8` and its shared storage, the
grouped decode over an int8 KV cache, `reason --rollout_int8` and the three
benches (tools/bench_sft.py, bench_grpo.py, bench_rollout.py).

Tiny configs on the CPU, fp32 compute; the JAX trainers run as their own
tests run them (plain attention), compiled whole and cached. Each test
states its tolerance.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bioreason_tpu import config as JC
from bioreason_tpu.data.nt_tokenizer import KmerTokenizer as JKmer
from bioreason_tpu.data.processor import BioProcessor as JProc
from bioreason_tpu.data.text_tokenizer import ByteTextTokenizer as JByte
from bioreason_tpu.generate.engine import GenerationEngine as JEngine
from bioreason_tpu.models import qwen3 as JQW
from bioreason_tpu.models.fusion import init_fusion as j_init
from bioreason_tpu.parallel import make_mesh
from bioreason_tpu.train import grpo as JG
from bioreason_tpu.train import lora as JL
from bioreason_tpu.train import rewards as JR
from bioreason_tpu.train.sft import SFTTrainer as JSFT
from bioreason_tpu_torch import config as TC
from bioreason_tpu_torch.data import BioProcessor, ByteTextTokenizer, KmerTokenizer
from bioreason_tpu_torch.data import collate as TD
from bioreason_tpu_torch.data import kegg as TK
from bioreason_tpu_torch.data.chat_template import apply_chat_template
from bioreason_tpu_torch.models import layers as L
from bioreason_tpu_torch.models import qwen3 as TQW
from bioreason_tpu_torch.train import grpo as TG
from bioreason_tpu_torch.train import lora as TL
from bioreason_tpu_torch.train import rewards as TR
from bioreason_tpu_torch.train.sft import SFTTrainer
from bioreason_tpu_torch.weights import from_jax_params

# one intra-op thread: the tensors here are tiny, and pytest-xdist runs
# several workers on the host's cores, which torch's default of a thread
# per core oversubscribes many times over
torch.set_num_threads(1)

TOK = ByteTextTokenizer()
PROC = BioProcessor(TOK, KmerTokenizer())
JPROC = JProc(JByte(), JKmer())
LORA = dict(r=4, alpha=8, dropout=0.0)
G, CLEN = 2, 6


def t(x):
    return torch.from_numpy(np.asarray(x))


def mesh():
    return make_mesh(JC.MeshConfig(data=1), devices=jax.devices()[:1])


def fusion_cfgs():
    """JAX and port tiny configs, decoder head dim 64, DNA up to 64 tokens."""
    jcfg = JC.FusionConfig.tiny(text_vocab=TOK.vocab_size, dna_pad_token_id=TOK.dna_pad_id)
    tcfg = TC.FusionConfig.tiny(text_vocab=TOK.vocab_size, dna_pad_token_id=TOK.dna_pad_id)
    return tuple(dataclasses.replace(c, decoder=dataclasses.replace(c.decoder, head_dim=64),
                                     max_length_dna=64) for c in (jcfg, tcfg))


@functools.lru_cache(maxsize=None)
def jax_init():
    """The JAX tiny fusion tree (fp32, no adapters), as numpy: a JAX
    trainer's update donates the device buffers it is given."""
    jcfg, _ = fusion_cfgs()
    return jax.tree.map(np.asarray, jax.jit(j_init, static_argnums=1)(jax.random.PRNGKey(0),
                                                                       jcfg))


def with_lora(tree, seed=0):
    """`tree` with the adapters a JAX trainer of `seed` attaches to it
    (train/sft.py and train/grpo.py: fold_in(PRNGKey(seed), 1))."""
    lora = JL.attach_lora(jax.random.fold_in(jax.random.PRNGKey(seed), 1), tree,
                          JC.LoRAConfig(**LORA))
    return jax.tree.map(np.asarray, lora)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def jax_path(name):
    """(JAX flat path of the port module `name`, layer index or None)."""
    parts = name.split(".")
    if len(parts) > 2 and parts[1] == "layers":
        return f"{parts[0]}/layers/{'/'.join(parts[3:])}", int(parts[2])
    return "/".join(parts), None


def jax_int8(jf, name):
    """The JAX {q, scale} of the port's int8 module `name`, in the port's
    layouts: q [out, in], scale [out, 1]."""
    path, i = jax_path(name)
    q, s = jf[f"{path}/kernel/q"], jf[f"{path}/kernel/scale"]
    if i is not None:
        q, s = q[i], s[i]
    return q.T, s.T


def int8_modules(model):
    return {n: m for n, m in model.named_modules()
            if isinstance(m, torch.nn.Linear) and L.is_int8(m)}


# -- SFT ------------------------------------------------------------------------------

def sft_cfgs(**kw):
    opt = dict(learning_rate=1e-2, total_steps=20, warmup_ratio=0.0, eps=1e-3)
    base = dict(batch_size=2, max_length_dna=64, bucket=None, frozen_dtype="int8", **kw)
    return tuple(C.SFTConfig(**base, optim=C.OptimConfig(**opt), lora=C.LoRAConfig(**LORA))
                 for C in (TC, JC))


@functools.lru_cache(maxsize=None)
def collated(seed):
    exs = [TK.format_kegg_for_dna_llm(it) for it in TK.synthetic_kegg_items(2, seq_len=40,
                                                                             seed=seed)]
    return TD.sft_collate(exs, PROC, 512, 64)


@functools.lru_cache(maxsize=None)
def jax_sft_run():
    """The JAX QLoRA SFTTrainer from `jax_init`: its parameters after the
    quantization and the bf16 cast, and each of two steps' metrics and
    trainable leaves."""
    jcfg, _ = fusion_cfgs()
    _, jsft = sft_cfgs()
    trainer = JSFT(jcfg, jsft, mesh=mesh(), params=jax_init())
    start = flat(jax.tree.map(np.asarray, trainer.params))
    metrics = [trainer.train_step(collated(s)) for s in (10, 11)]
    return start, metrics, flat(jax.tree.map(np.asarray, trainer.params))


def port_sft():
    _, tcfg = fusion_cfgs()
    tsft, _ = sft_cfgs()
    return SFTTrainer(tcfg, tsft, model=from_jax_params(with_lora(jax_init()), tcfg,
                                                        device="cpu"), device="cpu")


def test_quantize_and_frozen_cast_equal_the_jax_trainers_leaves():
    """The port's trainer quantizes its fp32 towers itself: every int8
    weight equals the JAX trainer's q, every scale its bf16 scale, and the
    dequantized weights (q * scale in the fp32 compute dtype) its
    dequantized leaves, bit for bit; the embedding and the stacked norms
    are bf16 and equal, the final norms fp32, the adapters and projection
    fp32 and trainable."""
    start, _, _ = jax_sft_run()
    trainer = port_sft()
    model = trainer.model
    mods = int8_modules(model)
    assert len(mods) == 2 * 7 * 2                   # the decoder's and the NT encoder's
    for name, mod in mods.items():
        q, s = jax_int8(start, name)
        assert mod.scale.dtype == torch.bfloat16 and s.dtype == jnp.bfloat16, name
        np.testing.assert_array_equal(mod.weight.numpy(), q, err_msg=name)
        np.testing.assert_array_equal(mod.scale.float().numpy(), s.astype(np.float32))
        want = q.astype(np.float32) * s.astype(np.float32)
        np.testing.assert_array_equal(L.int8_weight(mod, torch.float32).numpy(), want)
        assert not mod.weight.requires_grad and "weight" not in mod._parameters
    emb = model.decoder.embed.weight
    assert emb.dtype == torch.bfloat16
    np.testing.assert_array_equal(emb.float().numpy(),
                                  start["decoder/embed/embedding"].astype(np.float32))
    ln = model.decoder.layers[1].ln1.scale
    assert ln.dtype == torch.bfloat16 and model.decoder.final_norm.scale.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in trainer.params)
    assert sorted({n.rsplit(".", 1)[-1] for n in trainer.names}) == ["bias", "lora_a",
                                                                      "lora_b", "weight"]


def test_two_int8_sft_steps_match_jax():
    """Two QLoRA steps against the JAX trainer: loss and grad norm at rel
    1e-5, the adapters and the projection at atol 1e-5 (Adam eps 1e-3 on
    both sides, ROADMAP 3, note 7)."""
    _, jmetrics, jfinal = jax_sft_run()
    trainer = port_sft()
    for s, jm in zip((10, 11), jmetrics):
        m = trainer.train_step(collated(s))
        assert m["loss"] == pytest.approx(jm["loss"], rel=1e-5)
        assert m["grad_norm"] == pytest.approx(jm["grad_norm"], rel=1e-5)
    n = 0
    for name, p in trainer.trainable_state().items():
        path, i = jax_path(name.rsplit(".", 1)[0])
        leaf = name.rsplit(".", 1)[1]
        key = "kernel" if leaf == "weight" else leaf
        ref = jfinal[f"{path}/{key}"]
        ref = ref if i is None else ref[i]
        ref = ref.T if key == "kernel" else ref
        np.testing.assert_allclose(p.detach().numpy(), ref, atol=1e-5, rtol=0, err_msg=name)
        n += 1
    assert n == 2 * 7 * 2 + 2


def test_qlora_checkpoint_loads_back_the_trained_model(tmp_path):
    """A QLoRA trainer's checkpoint after two steps, rebuilt by
    `load_sft_model` and by `rebuild_sft`: the base is quantized again from
    the seed's weights, so every parameter and buffer (int8 weights, bf16
    scales and frozen leaves, the trained adapters) equals the trainer's,
    dtype included, and so do the logits, bit for bit. Folding the adapters
    into the int8 weights raises (`merge_lora`, `load_sft_for_grpo`), and
    the server
    keeps them beside the int8 weights: its greedy tokens are the
    trainer's model's, token for token."""
    from bioreason_tpu_torch import serve
    from bioreason_tpu_torch.models.fusion import fusion_forward
    from bioreason_tpu_torch.train.checkpoint import load_sft_for_grpo, load_sft_model, \
        rebuild_sft
    cfg = TC.FusionConfig(decoder=TC.DecoderConfig.tiny(vocab_size=TOK.vocab_size),
                          encoder=TC.EncoderConfig.tiny(), dna_pad_token_id=TOK.dna_pad_id,
                          max_length_dna=64)
    tsft, _ = sft_cfgs()
    trainer = SFTTrainer(cfg, dataclasses.replace(tsft, seed=5), device="cpu")
    for s in (10, 11):
        trainer.train_step(collated(s))
    path = str(tmp_path / "sft_final")
    trainer.save(path, {"decoder": "tiny", "encoder": "tiny"})
    batch = {k: torch.as_tensor(np.asarray(v)) for k, v in collated(12).items()
             if k in ("input_ids", "attention_mask", "dna_input_ids", "dna_attention_mask")}

    def logits(model, c):
        with torch.no_grad():
            return fusion_forward(model, c, **batch)[0]
    want = logits(trainer.model, cfg)
    state = {**dict(trainer.model.named_parameters()), **dict(trainer.model.named_buffers())}
    assert len(int8_modules(trainer.model)) == 2 * 7 * 2
    rebuilt = rebuild_sft(path, device="cpu")
    for c, model in ((cfg, load_sft_model(path, cfg, 5, "tiny", "tiny", device="cpu")),
                     rebuilt[:2]):
        got = {**dict(model.named_parameters()), **dict(model.named_buffers())}
        assert sorted(got) == sorted(state)
        for name, v in got.items():
            assert v.dtype == state[name].dtype and torch.equal(v, state[name]), name
        assert torch.equal(logits(model, c), want)
    with pytest.raises(ValueError, match="int8 weights"):
        TL.merge_lora(rebuilt[1])
    assert TL.has_lora(rebuilt[1])
    with pytest.raises(ValueError, match="int8 weights"):
        load_sft_for_grpo(path, cfg, TC.LoRAConfig(**LORA), 5, "tiny", "tiny", device="cpu")
    server = serve.build_server(checkpoint=path, device="cpu", max_length_dna=64)
    assert TL.has_lora(server.model) and int8_modules(server.model)
    items = [{"question": f"Is variant {k} pathogenic?", "answer": "",
              "reference_sequence": "ACGTTGCA" * (k + 2),
              "variant_sequence": "ACGTAGCA" * (k + 2)} for k in range(2)]
    inputs = serve.prepare_batch(server.processor, server.cfg, items)
    got, want = (server.engine.generate(m, *inputs, max_new_tokens=6, greedy=True)
                 for m in (server.model, trainer.model))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [dict(lora=None), dict(freeze_encoder=False)])
def test_sft_int8_refuses_what_jax_refuses(kw):
    """No LoRA, or a trained encoder: ValueError on both sides, with JAX's
    message (tests/test_train_sft.py:194)."""
    jcfg, tcfg = fusion_cfgs()
    tsft, jsft = sft_cfgs()
    with pytest.raises(ValueError, match="requires LoRA with a frozen encoder"):
        JSFT(jcfg, dataclasses.replace(jsft, **kw), mesh=mesh(), params=jax_init())
    with pytest.raises(ValueError, match="requires LoRA with a frozen encoder"):
        SFTTrainer(tcfg, dataclasses.replace(tsft, **kw),
                   model=from_jax_params(jax_init(), tcfg, device="cpu"), device="cpu")


# -- the int8 dense's backward --------------------------------------------------------

def saved_tensors(fn):
    """(result, [(shape, dtype)] of every tensor autograd saved in `fn`)."""
    seen = []

    def pack(x):
        seen.append((tuple(x.shape), x.dtype))
        return x
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        out = fn()
    return out, seen


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_dense_backward_keeps_the_int8_weight(dtype):
    """A decoder layer of int8 denses with bf16 scales under fp32 adapters:
    its output, dx and every adapter gradient through `Int8Linear` equal
    those of `F.linear` on the dequantized weights bit for bit, and no
    float tensor of a weight's [out, in] shape is saved for the backward
    (the float model's saves some: the check sees them)."""
    from bioreason_tpu_torch.train.quant import quantize_frozen_int8
    cfg = dataclasses.replace(TC.DecoderConfig.tiny(), head_dim=64, dtype="float32")
    torch.manual_seed(0)
    dec = L.init_normal_(TQW.Qwen3Decoder(cfg), torch.Generator().manual_seed(0))
    TL.attach_lora(dec, TC.LoRAConfig(**LORA), torch.Generator().manual_seed(1))
    for m in dec.modules():
        if L.has_adapter(m):
            m.lora_b.data.normal_(0, 0.1)
    quantize_frozen_int8(torch.nn.ModuleDict({"decoder": dec}), subtrees=("decoder",))
    for m in dec.modules():
        if isinstance(m, torch.nn.Linear):
            m.scale = m.scale.to(torch.bfloat16)
            m.bias = None
    shapes = {tuple(m.weight.shape) for m in dec.modules() if isinstance(m, torch.nn.Linear)}
    lp = dec.layers[0]
    adapters = [p for n, p in lp.named_parameters() if "lora_" in n]
    x0 = torch.randn((2, 5, cfg.hidden_size), generator=torch.Generator().manual_seed(2))
    pos = torch.arange(5)[None].expand(2, 5)
    mask = torch.ones((2, 5), dtype=torch.int32)

    def run():
        x = x0.to(dtype).requires_grad_(True)
        y = TQW._layer_forward(lp, x, dataclasses.replace(cfg, dtype=str(dtype)[6:]), pos,
                               mask, True)
        g = torch.autograd.grad(y.float().square().sum(), [x] + adapters)
        return y, g
    (y, g), saved = saved_tensors(run)
    assert not [s for s, dt in saved if dt.is_floating_point and s in shapes]
    plain = L.Int8Linear.apply
    try:
        L.Int8Linear.apply = lambda x, q, s, b: torch.nn.functional.linear(
            x, q.to(x.dtype) * s.to(x.dtype), b)
        (y2, g2), saved2 = saved_tensors(run)
    finally:
        L.Int8Linear.apply = plain
    assert [s for s, dt in saved2 if dt.is_floating_point and s in shapes]
    assert torch.equal(y, y2)
    for a, b in zip(g, g2):
        assert torch.equal(a, b)


# -- GRPO -------------------------------------------------------------------------------

def indexed_reward(prompts, completions, **kw):
    return [float(i % 3) for i in range(len(completions))]


def grpo_cfgs(**kw):
    """(port, JAX) GRPOConfigs of the same values; AdamW eps 1e-3."""
    def make(C):
        return C.GRPOConfig(**{
            "num_generations": G, "batch_size": 4, "max_completion_length": CLEN,
            "sampling": C.SamplingConfig(temperature=1.0, top_k=10, top_p=0.95,
                                         max_new_tokens=CLEN),
            "optim": C.OptimConfig(learning_rate=1e-2, total_steps=20, warmup_ratio=0.0,
                                   eps=1e-3),
            "lora": C.LoRAConfig(**LORA), "beta": 0.04, "epsilon_high": 0.28, **kw})
    return make(TC), make(JC)


def jax_grpo(**kw):
    jcfg, _ = fusion_cfgs()
    _, jg = grpo_cfgs(**kw)
    return JG.GRPOTrainer(jcfg, jg, JPROC, [indexed_reward, JR.correctness_reward],
                          mesh=mesh(), params=jax_init())


def port_grpo(**kw):
    _, tcfg = fusion_cfgs()
    tg, _ = grpo_cfgs(**kw)
    return TG.GRPOTrainer(tcfg, tg, PROC, [indexed_reward, TR.correctness_reward],
                          model=from_jax_params(with_lora(jax_init()), tcfg, device="cpu"),
                          device="cpu")


def unique_prompts(n=2):
    raw = [TK.format_kegg_prompt_only(it) for it in TK.synthetic_kegg_items(n, seq_len=24,
                                                                            seed=0)]
    out = PROC([apply_chat_template(ex)["prompt"] for ex in raw],
               [ex["dna_sequences"] for ex in raw], max_length_dna=64, padding_side="left")
    return out


@functools.lru_cache(maxsize=None)
def fixed_buffer():
    """2 prompts x G, the processor's left-padded prompts regrouped, CLEN
    random completion tokens (the last row ends at EOS), random advantages."""
    rep = TG._repeat_prompt_batch(unique_prompts(), G)
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


def fed(trainer, batch):
    """Make `step` train on `batch` instead of rolling out."""
    trainer._generate_and_score = lambda items: {
        "batch": batch, "completion_len": CLEN, "metrics": {}, "completions": [],
        "prompts": [], "rewards": []}
    return trainer


@functools.lru_cache(maxsize=None)
def jax_grpo_run():
    """The JAX QLoRA GRPOTrainer (rollout_int8): the buffer with its
    reference logps, two steps' metrics and the final trainable leaves."""
    jcfg, _ = fusion_cfgs()
    tr = jax_grpo(frozen_dtype="int8", rollout_int8=True)
    buf = dict(fixed_buffer())
    fn = jax.jit(JG.per_token_logps, static_argnames=("cfg", "completion_len"))
    ref = np.asarray(fn(tr._ref_params, jcfg, buf["full_ids"], buf["full_mask"],
                        buf["dna_input_ids"], buf["dna_attention_mask"], completion_len=CLEN))
    buf["ref_logps"] = ref + (np.random.default_rng(12).standard_normal(ref.shape)
                              * 0.3).astype(np.float32)
    fed(tr, {k: jnp.asarray(v) for k, v in buf.items()})
    metrics = [tr.step([]) for _ in range(2)]
    return buf, metrics, flat(jax.tree.map(np.asarray, tr.params))


def test_two_int8_grpo_updates_match_jax():
    """Two updates of the QLoRA trainers with rollout_int8 on one rollout
    buffer (the reference logps JAX's own): loss, kl, clip_ratio and grad
    norm at rel 1e-5, the adapters and the projection at atol 1e-5."""
    buf, jmetrics, jfinal = jax_grpo_run()
    trainer = fed(port_grpo(frozen_dtype="int8", rollout_int8=True),
                  {k: t(v) for k, v in buf.items()})
    for jm in jmetrics:
        m = trainer.step([])
        for key in ("loss", "kl", "clip_ratio", "grad_norm"):
            assert math.isfinite(m[key])
            assert m[key] == pytest.approx(jm[key], rel=1e-5, abs=1e-7), key
    for name, p in trainer.trainable_state().items():
        path, i = jax_path(name.rsplit(".", 1)[0])
        leaf = name.rsplit(".", 1)[1]
        key = "kernel" if leaf == "weight" else leaf
        ref = jfinal[f"{path}/{key}"]
        ref = ref if i is None else ref[i]
        np.testing.assert_allclose(p.detach().numpy(), ref.T if key == "kernel" else ref,
                                   atol=1e-5, rtol=0, err_msg=name)


def test_reference_and_rollout_models_share_the_int8_storage():
    """The port's form of tests/test_grpo.py:108: the reference and the
    rollout policy hold the training model's int8 weights and scales (the
    same storage), the rollout policy its live adapters and projection and
    an int8 embedding (the tied head) of its own; the reference has no
    adapter and a copy of the projection."""
    trainer = port_grpo(frozen_dtype="int8", rollout_int8=True)
    model, ref, roll = trainer.model, trainer.ref_model, trainer.rollout_model()
    assert roll is trainer.rollout_model()                      # built once
    ours = int8_modules(model)
    for other in (ref, roll):
        theirs = dict(other.named_modules())
        for name, mod in ours.items():
            assert theirs[name].weight.data_ptr() == mod.weight.data_ptr(), name
            assert theirs[name].scale.data_ptr() == mod.scale.data_ptr(), name
    assert not TL.has_lora(ref)
    assert ref.dna_projection.weight.data_ptr() != model.dna_projection.weight.data_ptr()
    live = dict(model.named_parameters())
    for name, p in roll.named_parameters():
        assert p is live[name], name
    emb = roll.decoder.embed
    assert L.is_int8(emb) and emb.scale.dtype == torch.float32
    assert model.decoder.embed.weight.dtype == torch.bfloat16       # training stays float
    with torch.no_grad():
        model.decoder.layers[0].attn.q.lora_b.add_(1.0)
    assert torch.equal(roll.decoder.layers[0].attn.q.lora_b,
                       model.decoder.layers[0].attn.q.lora_b)


@pytest.mark.parametrize("kw,match", [(dict(lora=None), "requires LoRA"),
                                      (dict(sync_ref_model=True),
                                       "incompatible with sync_ref_model")])
def test_grpo_int8_refuses_what_jax_refuses(kw, match):
    """tests/test_grpo.py:129: ValueError on both sides, JAX's messages."""
    with pytest.raises(ValueError, match=match):
        jax_grpo(frozen_dtype="int8", **kw)
    with pytest.raises(ValueError, match=match):
        port_grpo(frozen_dtype="int8", **kw)


def jax_rollout_tokens(tr, kv8):
    """JAX's greedy grouped rollout of `tr`'s rollout weights."""
    jcfg, _ = fusion_cfgs()
    out = unique_prompts()
    engine = JEngine(jcfg, eos_token_id=-1, kv_int8=kv8)
    ids, _ = engine.generate(tr._rollout_params(tr.params), out.input_ids, out.attention_mask,
                             out.dna_input_ids, out.dna_attention_mask, greedy=True,
                             max_new_tokens=8, group_size=G)
    return ids


@pytest.mark.parametrize("frozen", ["int8", "bfloat16"])
def test_int8_rollout_tokens_match_jax(frozen):
    """Greedy grouped rollouts of the rollout_int8 policy, on int8 frozen
    towers (shared int8 denses, the embedding quantized) and on a bf16
    tree (every dense, the embedding and the head quantized from bf16), on
    an int8 KV cache: the tokens equal JAX's `_rollout_params` through the
    JAX engine."""
    kw = dict(frozen_dtype=frozen, rollout_int8=True, rollout_kv_int8=True)
    want = jax_rollout_tokens(jax_grpo(**kw), True)
    trainer = port_grpo(**kw)
    roll = trainer.rollout_model()
    assert all(L.is_int8(m) for m in int8_modules(trainer.model).values())
    assert L.is_int8(roll.decoder.embed) and int8_modules(roll)
    out = unique_prompts()
    ids, _ = TG.GenerationEngine(trainer.fusion_cfg, -1, device="cpu", kv_int8=True).generate(
        roll, out.input_ids, out.attention_mask, out.dna_input_ids, out.dna_attention_mask,
        greedy=True, max_new_tokens=8, group_size=G)
    np.testing.assert_array_equal(ids, want)
    assert trainer.engine.kv_int8


# -- the grouped decode over int8 caches ------------------------------------------------

def test_grouped_decode_attention_with_scales_matches_jax():
    """`_grouped_decode_attention` on int8 prompt and decode caches with
    their scales (masked prompt pads, half-filled decode slots) against the
    JAX function on the same inputs, fp32, atol 1e-5."""
    rng = np.random.default_rng(7)
    bu, g, p, n, hq, hkv, d = 2, 3, 9, 5, 4, 2, 16
    q = rng.standard_normal((bu * g, 1, hq, d)).astype(np.float32)

    def cache(b, s):
        x = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
        sc = (np.abs(x).max(-1, keepdims=True) / 127.0).astype(np.float32)
        return np.clip(np.rint(x / sc), -127, 127).astype(np.int8), sc
    (pk, pks), (pv, pvs), (dk, dks), (dv, dvs) = cache(bu, p), cache(bu, p), \
        cache(bu * g, n), cache(bu * g, n)
    pmask = np.ones((bu, p), np.int32)
    pmask[0, :3] = 0
    dmask = np.zeros((bu * g, n), np.int32)
    dmask[:, :3] = 1
    want = np.asarray(jax.jit(JQW._grouped_decode_attention, static_argnums=7)(
        q, pk, pv, pmask, dk, dv, dmask, g, pks, pvs, dks, dvs))
    got = TQW._grouped_decode_attention(*(t(a) for a in (q, pk, pv, pmask, dk, dv, dmask)), g,
                                        *(t(a) for a in (pks, pvs, dks, dvs)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


# -- the CLI and the benches ------------------------------------------------------------

def test_reason_cli_rolls_out_int8(tmp_path):
    """`reason --rollout_int8` at tiny on the CPU: 2 finite steps, the
    rollouts on the int8 policy."""
    from bioreason_tpu_torch.cli import reason
    trainer = reason.main(["--decoder", "tiny", "--encoder", "tiny", "--device", "cpu",
                           "--seed", "3", "--num_generations", "2", "--batch_size", "4",
                           "--max_steps", "2", "--max_completion_length", "8",
                           "--max_length_dna", "64", "--rollout_int8",
                           "--checkpoint_dir", str(tmp_path / "ck"),
                           "--log_dir", str(tmp_path / "logs")])
    assert trainer.cfg.rollout_int8 and trainer.step_count == 2
    assert all(math.isfinite(m["loss"]) for m in trainer.metrics_history)
    assert L.is_int8(trainer.rollout_model().decoder.embed)
    assert not L.is_int8(trainer.model.decoder.embed)


@pytest.mark.parametrize("tool,argv,metric", [
    ("bench_sft", ["--frozen", "int8", "--steps", "1", "--fuse"], "sft_examples_per_sec_per_chip"),
    ("bench_sft", ["--steps", "1", "--reps", "1"], "sft_examples_per_sec_per_chip"),
    ("bench_sft", ["--steps", "1", "--reps", "1", "--remat", "dots"],
     "sft_examples_per_sec_per_chip"),
    ("bench_grpo", ["--remat", "dots", "--new", "4", "--steps", "1", "--probe"],
     "grpo_full_step_completions_per_sec_per_chip"),
    ("bench_grpo", ["--frozen", "int8", "--rollout_int8", "--new", "4", "--steps", "1",
                    "--probe"], "grpo_full_step_completions_per_sec_per_chip"),
    ("bench_rollout", ["--frozen", "int8", "--kv", "int8", "--new", "4", "--prompts", "2",
                       "--g", "2", "--reps", "1"], "grpo_rollout_tokens_per_sec_per_chip")])
def test_benches_print_one_json_line(tool, argv, metric, capsys):
    import importlib
    import json
    mod = importlib.import_module(f"bioreason_tpu_torch.tools.{tool}")
    res = mod.main(["--decoder", "tiny", "--encoder", "tiny", "--device", "cpu"] + argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == res
    assert res["metric"] == metric and res["value"] > 0 and res["device"] == "cpu"
    if tool == "bench_grpo":
        assert set(res["timers"]) >= {"prep", "rollout", "logps_dispatch", "rewards", "update"}


def test_benches_refuse_what_bench_py_refuses():
    """`--remat dots` is ported (bench.py's policy: the dense products kept),
    so both benches take it; `--frozen int8` with Evo2 stays refused."""
    from bioreason_tpu_torch.tools import bench_grpo, bench_sft
    assert bench_sft.parse_args(["--remat", "dots"]).remat == "dots"
    assert bench_grpo.parse_args(["--remat", "dots"]).remat == "dots"
    with pytest.raises(SystemExit):
        bench_sft.parse_args(["--frozen", "int8", "--encoder", "evo2-1b"])
