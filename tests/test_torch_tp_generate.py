"""Generation and GRPO under the mesh's 'model' axis (generate/engine.py with
a `MeshRun`, train/grpo.py at model > 1) in worlds of gloo ranks on the
CPU, fp32 at tiny width (decoder head dim 64), one module-scoped world per
mesh, (1, 1, 2) and (2, 1, 2):

  * the engine's greedy tokens against the JAX engine on parameters sharded
    over the same mesh (tests/test_generate.py:149-162), and every sampled
    logit row against one device (1e-5), ungrouped and grouped (G = 2),
    with a float and an int8 KV cache; each rank's cache holds Hkv/m heads,
    and a config whose Hkv does not divide m (one KV head) keeps the whole
    cache and still matches; the tiny MoE's experts split over 'model'
    beside its split attention;
  * two GRPO updates on one fixed rollout buffer (the rows split over data
    x fsdp) against one device (loss and grad norm 1e-5 relative, every
    trained parameter 1e-5), the first loss against the JAX GRPOTrainer on
    the same mesh shape (1e-5); two whole steps with their rollouts at
    (1, 1, 2) against one device, whose dp index draws as one device does;
    one at (2, 1, 2), where the model ranks of a data index emit the same
    completions;
  * int8 weights under the 'model' axis at (1, 1, 2), whole on every rank
    as JAX places them: two QLoRA SFT steps against one device (1e-5) and
    the first against the JAX SFTTrainer(frozen_dtype="int8") on the same
    mesh (1e-5 relative); two QLoRA GRPO updates with `rollout_int8` on one
    buffer against one device and the JAX trainer on its mesh (1e-5 / 1e-7
    absolute); the int8 rollout copy of a float tree equal to one device's
    bit for bit; the engine on it with an int8 KV cache against one device
    (greedy ids, logit rows within the float engine's int8-KV tolerance, 1e-4); the tiny MoE's
    QLoRA step with its int8 banks split over 'model' (1e-5); `tp_dense` on
    int8 linears in-process over a fake axis of two threads;
  * the launcher's check of ranks against cards, and `reason` /
    `train_sft --test_generative` under `--cpu_devices 2 --mesh 1,1,2` for
    one step against the one-device CLIs, and `reason --rollout_int8
    --rollout_kv_int8` for two steps, its checkpoint restored on one
    device."""

import dataclasses
import functools
import math

import numpy as np
import pytest
import torch

from test_torch_mesh import spawn_world

torch.set_num_threads(1)

MESHES = [(1, 1, 2), (2, 1, 2)]
INT8_MESH = MESHES[0]          # the int8 cases run in this world alone
NEW = 6                       # the engine's new tokens
G, CLEN = 2, 6                # GRPO: completions per prompt, completion length
ENGINE_CASES = [(kv, group, kv8) for kv in (2, 1) for group in (1, G) for kv8 in (False, True)]


def tok():
    from bioreason_tpu_torch.data import ByteTextTokenizer
    return ByteTextTokenizer()


def processor():
    from bioreason_tpu_torch.data import BioProcessor, KmerTokenizer
    return BioProcessor(tok(), KmerTokenizer())


def port_cfg(kv_heads=2, moe=False):
    from bioreason_tpu_torch import config as TC
    t = tok()
    cfg = TC.FusionConfig.tiny(text_vocab=t.vocab_size, dna_pad_token_id=t.dna_pad_id)
    dec = TC.DecoderConfig.tiny_moe(t.vocab_size) if moe else cfg.decoder
    return dataclasses.replace(cfg, decoder=dataclasses.replace(
        dec, head_dim=64, num_kv_heads=kv_heads), max_length_dna=64)


def jax_cfg():
    from bioreason_tpu import config as JC
    t = tok()
    cfg = JC.FusionConfig.tiny(text_vocab=t.vocab_size, dna_pad_token_id=t.dna_pad_id)
    return dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, head_dim=64),
                               max_length_dna=64)


def prompt_items(n_prompts, seed=0):
    from bioreason_tpu_torch.data import kegg as TK
    return [TK.format_kegg_prompt_only(it)
            for it in TK.synthetic_kegg_items(n_prompts, seq_len=24, seed=seed)]


@functools.lru_cache(maxsize=None)
def engine_inputs():
    """4 left-padded prompts with their DNA (numpy)."""
    from bioreason_tpu_torch.data.chat_template import apply_chat_template
    unique = prompt_items(4)
    out = processor()([apply_chat_template(ex)["prompt"] for ex in unique],
                      [ex["dna_sequences"] for ex in unique], max_length_dna=64,
                      padding_side="left")
    return out.input_ids, out.attention_mask, out.dna_input_ids, out.dna_attention_mask


def model_for(kv, jparams, moe=False):
    """The tiny fusion: the JAX trainer's weights at 2 KV heads, else (one
    KV head, or the tiny MoE) drawn from seed 0."""
    from bioreason_tpu_torch.models.fusion import init_fusion
    from bioreason_tpu_torch.weights import from_jax_params
    cfg = port_cfg(kv, moe)
    if kv == 2 and not moe:
        return from_jax_params(jparams, cfg, device="cpu")
    return init_fusion(cfg, seed=0, device="cpu")


def engine_run(model, cfg, run, group, kv8):
    """Greedy ids and mask, every logit row the sampler took, and the
    caches the engine made (each layer's entries as they end the call)."""
    from bioreason_tpu_torch.generate import engine as E
    rows, caches = [], []
    real_sample, real_init = E.sample_logits, E.init_cache

    def sample(logits, *a, **kw):
        rows.append(logits.detach().clone().numpy())
        return real_sample(logits, *a, **kw)

    def init(*a, **kw):
        cache = real_init(*a, **kw)
        caches.append(cache)
        return cache
    E.sample_logits, E.init_cache = sample, init
    try:
        eng = E.GenerationEngine(cfg, tok().eos_token_id, device="cpu", kv_int8=kv8, run=run)
        ids, mask = eng.generate(model, *engine_inputs(), greedy=True, max_new_tokens=NEW,
                                 group_size=group)
    finally:
        E.sample_logits, E.init_cache = real_sample, real_init
    return ids, mask, rows, [[{k: v.numpy() for k, v in e.items()} for e in c] for c in caches]


# -- GRPO ---------------------------------------------------------------------------

def grpo_cfg(module, **kw):
    return module.GRPOConfig(**{
        "num_generations": G, "batch_size": 4, "max_completion_length": CLEN, "beta": 0.04,
        "sampling": module.SamplingConfig(temperature=1.0, top_k=10, top_p=0.95,
                                          max_new_tokens=CLEN),
        "optim": module.OptimConfig(learning_rate=1e-2, total_steps=20, warmup_ratio=0.0,
                                    eps=1e-3),
        "lora": module.LoRAConfig(r=4, alpha=8, dropout=0.0), "frozen_dtype": "", **kw})


def port_grpo(init, mesh=None, **kw):
    from bioreason_tpu_torch import config as TC
    from bioreason_tpu_torch.train.grpo import GRPOTrainer
    from bioreason_tpu_torch.train.rewards import correctness_reward
    cfg = port_cfg()
    return GRPOTrainer(cfg, grpo_cfg(TC, **kw), processor(), [correctness_reward],
                       model=model_for(2, init), device="cpu", mesh=mesh)


@functools.lru_cache(maxsize=None)
def fixed_buffer():
    """2 prompts x G, regrouped by `_repeat_prompt_batch`, then CLEN random
    completion tokens (the last row ends early at EOS) and advantages."""
    from bioreason_tpu_torch.data.chat_template import apply_chat_template
    from bioreason_tpu_torch.train.grpo import _repeat_prompt_batch
    unique = prompt_items(2)
    out = processor()([apply_chat_template(ex)["prompt"] for ex in unique],
                      [ex["dna_sequences"] for ex in unique], max_length_dna=64,
                      padding_side="left")
    rep = _repeat_prompt_batch(out, G)
    rng = np.random.default_rng(11)
    eos = tok().eos_token_id
    comp = rng.integers(3, 256, (2 * G, CLEN)).astype(np.int32)
    cmask = np.ones((2 * G, CLEN), np.int32)
    comp[-1, 3:] = eos
    cmask[-1, 4:] = 0
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


QLORA = dict(frozen_dtype="int8", rollout_int8=True)


@functools.lru_cache(maxsize=None)
def jax_grpo(mesh_shape, **kw):
    """The JAX GRPOTrainer on `mesh_shape` over the CPU devices (`kw` its
    GRPOConfig's other fields): its initial parameters (LoRA attached; int8
    leaves under QLoRA), the fixed buffer with its reference policy's
    logps, and its first step's metrics on that buffer. A QLoRA trainer
    quantizes the float trainer's initial tree, the one the port's models
    are built from (its frozen leaves stored bf16)."""
    return run_jax_grpo(jax_grpo(MESHES[0])[0] if kw else None, mesh_shape, **kw)


def run_jax_grpo(params, mesh_shape, **kw):
    """`jax_grpo` from `params` (None: drawn from PRNGKey(0))."""
    import jax
    import jax.numpy as jnp
    from bioreason_tpu import config as JC
    from bioreason_tpu.data.nt_tokenizer import KmerTokenizer as JKmer
    from bioreason_tpu.data.processor import BioProcessor as JProc
    from bioreason_tpu.data.text_tokenizer import ByteTextTokenizer as JByte
    from bioreason_tpu.models.fusion import init_fusion as j_init
    from bioreason_tpu.parallel import make_mesh
    from bioreason_tpu.train import grpo as JG
    from bioreason_tpu.train import rewards as JR
    jcfg = jax_cfg()
    if params is None:
        params = jax.jit(j_init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    n = int(np.prod(mesh_shape))
    mesh = make_mesh(JC.MeshConfig(*mesh_shape), devices=jax.devices()[:n])
    tr = JG.GRPOTrainer(jcfg, grpo_cfg(JC, **kw), JProc(JByte(), JKmer()),
                        [JR.correctness_reward], mesh=mesh, params=params)
    init = jax.tree.map(np.asarray, tr.params)
    buf = dict(fixed_buffer())
    logps = jax.jit(JG.per_token_logps, static_argnames=("cfg", "completion_len"))
    ref = np.asarray(logps(tr._ref_params, jcfg, buf["full_ids"], buf["full_mask"],
                           buf["dna_input_ids"], buf["dna_attention_mask"],
                           completion_len=CLEN))
    noise = np.random.default_rng(12).standard_normal(ref.shape).astype(np.float32) * 0.3
    buf["ref_logps"] = ref + noise
    fed(tr, {k: jnp.asarray(v) for k, v in buf.items()})
    return init, buf, tr.step([])


def grpo_updates(init, buf, mesh=None, **kw):
    """Two steps on the fixed buffer (this rank's rows under a mesh):
    metrics and the whole trainable parameters after them."""
    tr = port_grpo(init, mesh, **kw)
    rows = (lambda x: x) if mesh is None else tr.run.rows
    fed(tr, {k: None if v is None else torch.as_tensor(rows(np.asarray(v)))
             for k, v in buf.items()})
    metrics = [tr.step([]) for _ in range(2)]
    return metrics, {k: v.detach().numpy() for k, v in tr.trainable_state().items()}


def grpo_steps(init, mesh=None, steps=2):
    """`steps` whole steps (rollouts sampled, correctness reward): metrics,
    the completions and the parameters after them."""
    tr = port_grpo(init, mesh)
    items = [x for x in prompt_items(2, seed=5) for _ in range(G)]
    metrics, completions = [], []
    for _ in range(steps):
        metrics.append(tr.step(items))
        completions.append(list(tr.last_completions))
    return metrics, completions, {k: v.detach().numpy() for k, v in
                                  tr.trainable_state().items()}


# -- int8 weights under the mesh -------------------------------------------------------

def sft_cfg(module, **kw):
    """test_torch_qlora's QLoRA SFTConfig (2 rows a batch)."""
    return module.SFTConfig(**{
        "batch_size": 2, "max_length_dna": 64, "bucket": None, "frozen_dtype": "int8",
        "optim": module.OptimConfig(learning_rate=1e-2, total_steps=20, warmup_ratio=0.0,
                                    eps=1e-3),
        "lora": module.LoRAConfig(r=4, alpha=8, dropout=0.0), **kw})


@functools.lru_cache(maxsize=None)
def sft_batch(seed):
    from bioreason_tpu_torch.data import collate as TD
    from bioreason_tpu_torch.data import kegg as TK
    exs = [TK.format_kegg_for_dna_llm(it) for it in TK.synthetic_kegg_items(2, seq_len=40,
                                                                             seed=seed)]
    return TD.sft_collate(exs, processor(), 512, 64)


def qlora_sft(model, cfg, mesh=None):
    """Two QLoRA SFT steps of `model`: metrics and the whole trained leaves."""
    from bioreason_tpu_torch import config as TC
    from bioreason_tpu_torch.train.sft import SFTTrainer
    tr = SFTTrainer(cfg, sft_cfg(TC), model=model, device="cpu", mesh=mesh)
    metrics = [tr.train_step(sft_batch(s)) for s in (10, 11)]
    return metrics, {k: v.detach().numpy() for k, v in tr.trainable_state().items()}


@functools.lru_cache(maxsize=None)
def jax_qlora_sft(mesh_shape):
    """The first step of the JAX QLoRA SFTTrainer on `mesh_shape` from the
    GRPO trainer's initial tree (the same LoRA draws: both trainers attach
    them from fold_in(PRNGKey(0), 1))."""
    import jax
    from bioreason_tpu import config as JC
    from bioreason_tpu.parallel import make_mesh
    from bioreason_tpu.train.sft import SFTTrainer as JSFT
    init, _, _ = jax_grpo(MESHES[0])
    n = int(np.prod(mesh_shape))
    tr = JSFT(jax_cfg(), sft_cfg(JC), mesh=make_mesh(JC.MeshConfig(*mesh_shape),
                                                     devices=jax.devices()[:n]),
              params=init)
    return tr.train_step(sft_batch(10))


def int8_state(model):
    """name -> numpy of every int8 weight and scale `model` holds."""
    from bioreason_tpu_torch.parallel.partition import int8_buffers
    return {k: v.detach().numpy() for k, v in int8_buffers(model).items()}


def rollout_copy(init, mesh=None):
    """The `rollout_int8` copy of the float tree: its int8 weights and
    scales, and the engine's greedy runs on it with an int8 KV cache,
    ungrouped and at G."""
    tr = port_grpo(init, mesh, rollout_int8=True)
    roll = tr.rollout_model()
    return int8_state(roll), {g: engine_run(roll, port_cfg(), tr.run, g, True) for g in (1, G)}


def int8_cases(init, buf8, mesh):
    """Every int8 case of the (1, 1, 2) world on this rank."""
    from bioreason_tpu_torch.models.fusion import init_fusion
    out = {"sft": qlora_sft(model_for(2, init), port_cfg(), mesh),
           "updates": grpo_updates(init, buf8, mesh, **QLORA),
           "rollout": rollout_copy(init, mesh),
           "moe": qlora_sft(init_fusion(port_cfg(moe=True), seed=0, device="cpu"),
                            port_cfg(moe=True), mesh)}
    return out


def split_pieces(model):
    """This rank's pieces of the decoder's table and the DNA projection,
    and whether the table is marked vocab-parallel."""
    from bioreason_tpu_torch.models.layers import vocab_axis
    return {"table": tuple(model.decoder.embed.weight.shape),
            "vocab_split": vocab_axis(model.decoder.embed) is not None,
            "projection": tuple(model.dna_projection.weight.shape)}


def _world(rank, world, mesh_shape, init, buf, buf8):
    from bioreason_tpu_torch.config import MeshConfig
    from bioreason_tpu_torch.parallel.mesh import make_mesh
    from bioreason_tpu_torch.parallel.trainer import MeshRun
    mesh = make_mesh(MeshConfig(*mesh_shape), device="cpu")
    out = {"engine": {}, "tp_mlp": {}, "moe": {}, "pieces": {}}
    for kv, group, kv8 in ENGINE_CASES:
        model = model_for(kv, init)
        run = MeshRun(mesh, model, port_cfg(kv).decoder)
        out["pieces"]["engine"] = split_pieces(model)
        out["tp_mlp"][kv] = getattr(model.decoder.layers[0].mlp.gate, "tp", None) is not None
        out["engine"][(kv, group, kv8)] = engine_run(model, port_cfg(kv), run, group, kv8)
    for group in (1, G):          # the tiny MoE: experts over 'model', attention split
        model = model_for(2, init, moe=True)
        run = MeshRun(mesh, model, port_cfg(moe=True).decoder)
        out["moe"][group] = engine_run(model, port_cfg(moe=True), run, group, False)
    tr = port_grpo(init, mesh)
    out["pieces"].update(policy=split_pieces(tr.model), reference=split_pieces(tr.ref_model))
    out["updates"] = grpo_updates(init, buf, mesh)
    out["steps"] = grpo_steps(init, mesh, steps=2 if mesh_shape[0] == 1 else 1)
    if buf8 is not None:
        out["int8"] = int8_cases(init, buf8, mesh)
    out["coords"] = (rank // (mesh_shape[1] * mesh_shape[2]), rank % mesh_shape[2])
    return out


@pytest.fixture(scope="module", params=MESHES, ids=lambda m: "x".join(map(str, m)))
def world(request, tmp_path_factory):
    mesh_shape = request.param
    init, buf, _ = jax_grpo(mesh_shape)
    buf8 = jax_grpo(mesh_shape, **QLORA)[1] if mesh_shape == INT8_MESH else None
    n = int(np.prod(mesh_shape))
    return mesh_shape, spawn_world(_world, n, tmp_path_factory.mktemp("tp"), mesh_shape,
                                   init, buf, buf8)


@functools.lru_cache(maxsize=None)
def one_device_engine(kv, group, kv8):
    init, _, _ = jax_grpo(MESHES[0])
    return engine_run(model_for(kv, init), port_cfg(kv), None, group, kv8)


@functools.lru_cache(maxsize=None)
def jax_engine_tokens(mesh_shape):
    """The JAX engine's greedy tokens on its parameters sharded over the
    mesh (tests/test_generate.py:149-162)."""
    import jax
    from bioreason_tpu import config as JC
    from bioreason_tpu.generate import GenerationEngine as JEngine
    from bioreason_tpu.models.fusion import init_fusion as j_init
    from bioreason_tpu.parallel import make_mesh
    from bioreason_tpu.parallel.partition import partition_rules_fusion, shardings_for_params
    init, _, _ = jax_grpo(MESHES[0])
    params = {k: v for k, v in init.items()}
    n = int(np.prod(mesh_shape))
    mesh = make_mesh(JC.MeshConfig(*mesh_shape), devices=jax.devices()[:n])
    sharded = jax.device_put(params, shardings_for_params(params, partition_rules_fusion(),
                                                          mesh))
    ids, _ = JEngine(jax_cfg(), eos_token_id=tok().eos_token_id).generate(
        sharded, *engine_inputs(), greedy=True, max_new_tokens=NEW)
    return np.asarray(ids)


# An int8 cache rounds each K / V row to 1/127 of its absmax. Under tensor
# parallelism the rowwise products sum their halves over the ranks, so the
# residual stream differs from one device's in the last bits, and a K / V
# value that lies on a rounding boundary takes the neighbouring code. The
# codes are held to one device's exactly but for such flips (at most one
# code apart, under 1% of them); the logits they give move by up to ~2.5e-5
# (measured), so the int8 rows are held at 1e-4 and the float rows at 1e-5.
INT8_FLIPS = 1e-2
LOGIT_ATOL = {False: 1e-5, True: 1e-4}


@pytest.mark.parametrize("kv,group,kv8", ENGINE_CASES)
def test_engine_under_tp_matches_one_device(world, kv, group, kv8):
    """Every rank's ids equal one device's, every logit row the sampler took
    is within LOGIT_ATOL of one device's, and each rank's caches hold
    Hkv/m heads (every head where Hkv does not divide m, with the MLP still
    split): one device's heads of this rank, at 1e-5 (float) or the same
    int8 codes but for boundary flips, scales at 1e-5 relative."""
    mesh_shape, results = world
    m = mesh_shape[2]
    ids, mask, rows, caches = one_device_engine(kv, group, kv8)
    local = kv // m if kv % m == 0 else kv
    for res in results:
        got_ids, got_mask, got_rows, got_caches = res["engine"][(kv, group, kv8)]
        np.testing.assert_array_equal(got_ids, ids)
        np.testing.assert_array_equal(got_mask, mask)
        assert len(got_rows) == len(rows)
        for a, b in zip(got_rows, rows):
            np.testing.assert_allclose(a, b, atol=LOGIT_ATOL[kv8], rtol=0)
        assert len(got_caches) == len(caches) == (2 if group > 1 else 1)
        heads = (slice(None) if local == kv
                 else slice(res["coords"][1] * local, (res["coords"][1] + 1) * local))
        flips = codes = 0
        for cache, want_cache in zip(got_caches, caches):
            for entry, want in zip(cache, want_cache):
                assert entry["k"].shape[2] == local and want["k"].shape[2] == kv
                assert entry["k"].shape[3] == 64
                for key in entry:
                    got, ref = entry[key], want[key][:, :, heads]
                    assert got.shape == ref.shape, key
                    if key in ("k", "v") and kv8:
                        diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
                        assert diff.max() <= 1, key
                        flips, codes = flips + int((diff > 0).sum()), codes + diff.size
                    elif kv8:
                        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-12)
                    else:
                        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
        assert flips <= INT8_FLIPS * max(codes, 1), (flips, codes)
        assert res["tp_mlp"][kv]


def test_ranks_hold_their_table_and_projection_rows(world):
    """The engine's model under `MeshRun`, the GRPO policy and its reference
    policy each hold V/m rows of the decoder's table, marked vocab-parallel,
    and H/m output rows of the DNA projection on every rank: the engine
    and GRPO cases of this world run the split head and projection."""
    mesh_shape, results = world
    _, f, m = mesh_shape
    cfg = port_cfg()
    v, h, d = cfg.decoder.vocab_size, cfg.decoder.hidden_size, cfg.encoder.hidden_size
    want = {"table": (v // m, h // f), "vocab_split": True, "projection": (h // m, d // f)}
    for res in results:
        assert set(res["pieces"]) == {"engine", "policy", "reference"}
        for label, got in res["pieces"].items():
            assert got == want, label


@pytest.mark.parametrize("group", [1, G])
def test_moe_engine_under_model_axis_matches_one_device(world, group):
    """The tiny MoE (E=4, k=2): experts split over 'model' beside the
    tensor-parallel attention; greedy ids equal and logit rows within 1e-5
    of one device, ungrouped and grouped."""
    _, results = world
    init, _, _ = jax_grpo(MESHES[0])
    ids, _, rows, _ = engine_run(model_for(2, init, moe=True), port_cfg(moe=True), None,
                                 group, False)
    for res in results:
        got_ids, _, got_rows, caches = res["moe"][group]
        np.testing.assert_array_equal(got_ids, ids)
        for a, b in zip(got_rows, rows):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
        assert caches[0][0]["k"].shape[2] == 1


def test_engine_under_tp_matches_jax_sharded(world):
    """Greedy tokens equal the JAX engine's on parameters sharded over the
    same mesh."""
    mesh_shape, results = world
    want = jax_engine_tokens(mesh_shape)
    for res in results:
        np.testing.assert_array_equal(res["engine"][(2, 1, False)][0], want)


def test_grpo_update_under_tp_matches_one_device_and_jax(world):
    """Two updates on the fixed buffer: loss, kl and grad norm at 1e-5
    relative and every trained parameter at 1e-5 against one device; the
    first loss against the JAX GRPOTrainer on the same mesh shape."""
    mesh_shape, results = world
    init, buf, jmetrics = jax_grpo(mesh_shape)
    want_m, want_s = grpo_updates(init, buf)
    assert results[0]["updates"][0][0]["loss"] == pytest.approx(float(jmetrics["loss"]),
                                                                rel=1e-5, abs=1e-7)
    for res in results:
        got_m, got_s = res["updates"]
        for g, w in zip(got_m, want_m):
            for k in ("loss", "kl", "grad_norm"):
                assert g[k] == pytest.approx(w[k], rel=1e-5, abs=1e-7), k
        assert set(got_s) == set(want_s)
        for k in want_s:
            np.testing.assert_allclose(got_s[k], want_s[k], atol=1e-5, rtol=0, err_msg=k)


def test_grpo_steps_under_tp(world):
    """Whole steps with their rollouts: at (1, 1, 2) two steps equal one
    device's (the completions, loss and grad norm 1e-5, the parameters
    1e-5); at (2, 1, 2) the model ranks of each data index emit the same
    completions and every metric is finite."""
    mesh_shape, results = world
    for res in results:
        metrics, _, _ = res["steps"]
        assert all(math.isfinite(m[k]) for m in metrics for k in ("loss", "kl", "reward"))
    by_data = {}
    for res in results:
        by_data.setdefault(res["coords"][0], []).append(res["steps"][1])
    for comps in by_data.values():
        assert all(c == comps[0] for c in comps)
    if mesh_shape[0] == 1:
        init, _, _ = jax_grpo(mesh_shape)
        want_m, want_c, want_s = grpo_steps(init)
        got_m, got_c, got_s = results[0]["steps"]
        assert got_c == want_c
        for g, w in zip(got_m, want_m):
            for k in ("loss", "kl", "grad_norm", "reward"):
                assert g[k] == pytest.approx(w[k], rel=1e-5, abs=1e-7), k
        for k in want_s:
            np.testing.assert_allclose(got_s[k], want_s[k], atol=1e-5, rtol=0, err_msg=k)


def _int8_world(world):
    mesh_shape, results = world
    assert mesh_shape == INT8_MESH
    return [res["int8"] for res in results]


# the int8 cases run in the (1, 1, 2) world alone
in_int8_world = pytest.mark.parametrize("world", [INT8_MESH], indirect=True,
                                        ids=lambda m: "x".join(map(str, m)))


@in_int8_world
def test_qlora_sft_under_model_axis_matches_one_device_and_jax(world):
    """Two QLoRA SFT steps at (1, 1, 2), the int8 q / k / v / gate / up
    computing on their rank's rows and o / down on their columns of the
    replicated int8 weights: losses, grad-norms and the gathered adapters
    against one device (rel 1e-5, atol 1e-5), the first step against the
    JAX SFTTrainer(frozen_dtype="int8") on the same mesh (rel 1e-5)."""
    from test_torch_parallel_train import _same_run
    results = _int8_world(world)
    init, _, _ = jax_grpo(MESHES[0])
    want = qlora_sft(model_for(2, init), port_cfg())
    jm = jax_qlora_sft(INT8_MESH)
    for res in results:
        _same_run(res["sft"], want)
    assert results[0]["sft"][0][0]["loss"] == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert results[0]["sft"][0][0]["grad_norm"] == pytest.approx(float(jm["grad_norm"]),
                                                                 rel=1e-5)


@in_int8_world
def test_qlora_grpo_update_under_model_axis_matches_one_device_and_jax(world):
    """Two QLoRA updates (`rollout_int8`) on the JAX QLoRA trainer's buffer
    at (1, 1, 2): loss, kl and grad norm (rel 1e-5, abs 1e-7) and the
    adapters (1e-5) against one device, the first loss against the JAX
    trainer on the same mesh."""
    results = _int8_world(world)
    init, _, _ = jax_grpo(MESHES[0])
    _, buf8, jm = jax_grpo(INT8_MESH, **QLORA)
    want_m, want_s = grpo_updates(init, buf8, None, **QLORA)
    assert results[0]["updates"][0][0]["loss"] == pytest.approx(float(jm["loss"]), rel=1e-5,
                                                                abs=1e-7)
    for res in results:
        got_m, got_s = res["updates"]
        for g, w in zip(got_m, want_m):
            for k in ("loss", "kl", "grad_norm"):
                assert g[k] == pytest.approx(w[k], rel=1e-5, abs=1e-7), k
        assert set(got_s) == set(want_s)
        for k in want_s:
            np.testing.assert_allclose(got_s[k], want_s[k], atol=1e-5, rtol=0, err_msg=k)


@functools.lru_cache(maxsize=None)
def one_device_rollout():
    init, _, _ = jax_grpo(MESHES[0])
    return rollout_copy(init)


@in_int8_world
def test_int8_rollout_copy_under_model_axis_is_one_devices_bitwise(world):
    """`rollout_int8` on a float tree at (1, 1, 2): every int8 weight and
    scale of the rollout copy (both towers, the embedding) is whole on each
    rank and equal to one device's bit for bit, as JAX quantizes whole rows
    and places the leaves P(); so each rank holds one device's int8 bytes."""
    results = _int8_world(world)
    want, _ = one_device_rollout()
    assert any(k.startswith("decoder.embed.") for k in want) and len(want) > 40
    for res in results:
        got, _ = res["rollout"]
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@in_int8_world
@pytest.mark.parametrize("group", [1, G])
def test_int8_engine_under_model_axis_matches_one_device(world, group):
    """The engine on the int8 rollout copy with an int8 KV cache at
    (1, 1, 2), ungrouped and grouped: greedy ids equal one device's, every
    logit row the sampler took within the float engine's int8-KV 1e-4, and each
    rank's caches hold Hkv/2 heads."""
    results = _int8_world(world)
    _, engines = one_device_rollout()
    ids, mask, rows, caches = engines[group]
    for res in results:
        got_ids, got_mask, got_rows, got_caches = res["rollout"][1][group]
        np.testing.assert_array_equal(got_ids, ids)
        np.testing.assert_array_equal(got_mask, mask)
        assert len(got_rows) == len(rows)
        for a, b in zip(got_rows, rows):
            np.testing.assert_allclose(a, b, atol=LOGIT_ATOL[True], rtol=0)
        assert got_caches[0][0]["k"].dtype == np.int8
        assert got_caches[0][0]["k"].shape[2] * 2 == caches[0][0]["k"].shape[2]


@in_int8_world
def test_moe_qlora_under_model_axis_matches_one_device(world):
    """The tiny MoE (E=4, k=2) under QLoRA at (1, 1, 2): its int8 banks and
    router whole on each rank, each rank running its 2 experts and its
    heads; two steps against one device (rel 1e-5, atol 1e-5)."""
    from bioreason_tpu_torch.models.fusion import init_fusion
    from test_torch_parallel_train import _same_run
    results = _int8_world(world)
    want = qlora_sft(init_fusion(port_cfg(moe=True), seed=0, device="cpu"), port_cfg(moe=True))
    for res in results:
        _same_run(res["moe"], want)


class ThreadAxis:
    """A fake 'model' axis of two ranks run as two threads of this process:
    `comm.all_reduce` sums the ranks' tensors through a barrier."""

    def __init__(self, n=2):
        import threading
        self.n, self.barrier, self.slots = n, threading.Barrier(n), [None] * n

    def all_reduce(self, x, axis):
        self.slots[axis.index] = x.detach().clone()
        self.barrier.wait()
        total = sum(self.slots)
        self.barrier.wait()
        return total

    def run(self, fn):
        """fn(axis) on every rank's thread; their results in rank order."""
        import threading
        from bioreason_tpu_torch.parallel.comm import Axis
        out, errs = [None] * self.n, []

        def main(i):
            try:
                out[i] = fn(Axis("model", None, self.n, i, tuple(range(self.n))))
            except BaseException as e:          # re-raised below
                errs.append(e)
                self.barrier.abort()
        threads = [threading.Thread(target=main, args=(i,)) for i in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errs:
            raise errs[0]
        return out


@pytest.mark.parametrize("kind", ["col", "row"])
@pytest.mark.parametrize("adapter", [False, True])
def test_tp_dense_on_int8_linears_matches_one_device(monkeypatch, kind, adapter):
    """`layers.tp_dense` on an int8 linear (bf16 scales, as QLoRA stores
    them; with a bias), its weight and scale whole on both ranks of a fake
    axis: colwise each rank's output rows, rowwise its input columns summed
    in fp32 with the scale applied once; the output and x's gradient
    against one device's `dense` (1e-5 relative to max |y|, |dx|), the
    adapters' gradients too, and a rank's backward saves no float weight."""
    import copy

    from bioreason_tpu_torch.models import layers as L
    from bioreason_tpu_torch.parallel import comm
    from bioreason_tpu_torch.train.quant import quantize_kernel_int8, store_int8
    rng = np.random.default_rng(5)
    lin = torch.nn.Linear(16, 12)
    with torch.no_grad():
        lin.weight.copy_(torch.as_tensor(rng.standard_normal((12, 16)), dtype=torch.float32))
        lin.bias.copy_(torch.as_tensor(rng.standard_normal(12), dtype=torch.float32))
    store_int8(lin, *quantize_kernel_int8(lin.weight))
    lin.scale = lin.scale.to(torch.bfloat16)
    if adapter:
        L.add_adapter(lin, torch.as_tensor(rng.standard_normal((16, 4)), dtype=torch.float32),
                      torch.as_tensor(rng.standard_normal((4, 12)), dtype=torch.float32), 2.0)
    x0 = torch.as_tensor(rng.standard_normal((3, 5, 16)), dtype=torch.float32)
    gy = torch.as_tensor(rng.standard_normal((3, 5, 12)), dtype=torch.float32)
    x = x0.clone().requires_grad_(True)
    want_y = L.dense(lin, x)
    want_g = torch.autograd.grad(want_y, [x] + ([lin.lora_a, lin.lora_b] if adapter else []), gy)
    fake = ThreadAxis()
    monkeypatch.setattr(comm, "all_reduce", fake.all_reduce)

    def rank(axis):
        mod = copy.deepcopy(lin)
        if adapter:                 # the adapter's pieces, as the plan slices them
            name, dim = ("lora_b", 1) if kind == "col" else ("lora_a", 0)
            setattr(mod, name, torch.nn.Parameter(
                comm.local_slice(getattr(lin, name).detach(), axis, dim).clone()))
        mod.tp = (kind, axis)
        xr = (x0 if kind == "col" else comm.local_slice(x0, axis, 2)).clone().requires_grad_(True)
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t,
                                                      lambda t: t):
            y = L.dense(mod, xr)
        g = torch.autograd.grad(y, [xr] + ([mod.lora_a, mod.lora_b] if adapter else []),
                                comm.local_slice(gy, axis, 2) if kind == "col" else gy)
        return y.detach(), [t.detach() for t in g], saved
    ranks = fake.run(rank)
    (y0, g0, _), (y1, g1, _) = ranks
    if kind == "col":       # output rows per rank; x's gradient summed over the axis
        y, dx = torch.cat([y0, y1], -1), g0[0]
        torch.testing.assert_close(g1[0], dx, rtol=0, atol=0)
    else:                   # the summed output on both ranks; x's gradient per column
        y, dx = y0, torch.cat([g0[0], g1[0]], -1)
        torch.testing.assert_close(y1, y0, rtol=0, atol=0)
    close = lambda got, want: torch.testing.assert_close(
        got, want.detach(), rtol=0, atol=1e-5 * float(want.detach().abs().max()))
    close(y, want_y)
    close(dx, want_g[0])
    if adapter:             # lora_a / lora_b: whole on a rank, or its slice
        if kind == "col":
            close(g0[1], want_g[1])
            close(torch.cat([g0[2], g1[2]], 1), want_g[2])
        else:
            close(torch.cat([g0[1], g1[1]], 0), want_g[1])
            close(g0[2], want_g[2])
    for _, _, saved in ranks:   # the int8 slice, never a float [6, 16] / [12, 8] weight
        assert any(t.dtype == torch.int8 for t in saved)
        assert not any(t.is_floating_point() and tuple(t.shape) in ((6, 16), (12, 8), (8, 12))
                       for t in saved)


@pytest.mark.parametrize("local_world,local_rank,cards,ok", [
    (1, 0, 1, True), (4, 3, 4, True), (2, 0, 1, False), (2, 1, 1, False), (1, 1, 1, False)])
def test_a_launcher_needs_a_card_per_rank(local_world, local_rank, cards, ok):
    from bioreason_tpu_torch.cli.common import check_cards
    if ok:
        check_cards(local_world, local_rank, cards)
    else:
        with pytest.raises(RuntimeError, match="one rank per card"):
            check_cards(local_world, local_rank, cards)


def test_run_with_mesh_refuses_more_ranks_than_cards(monkeypatch):
    """Under a launcher on CUDA, two ranks on this host and one card fail
    with the message before any rank picks a card or NCCL."""
    import argparse

    from bioreason_tpu_torch.cli import common
    from bioreason_tpu_torch.utils import devices
    monkeypatch.setattr(devices, "resolve_device", lambda d=None: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: pytest.fail("set_device ran"))
    for k, v in (("WORLD_SIZE", "2"), ("LOCAL_WORLD_SIZE", "2"), ("RANK", "1"),
                 ("LOCAL_RANK", "1")):
        monkeypatch.setenv(k, v)
    args = argparse.Namespace(cpu_devices=0, mesh="1,1,2", device=None)
    with pytest.raises(RuntimeError, match="2 ranks on this host"):
        common.run_with_mesh(args, lambda a, m: pytest.fail("fn ran"))


# -- the CLIs -----------------------------------------------------------------------

def test_reason_cli_cpu_devices_2_mesh_1_1_2(tmp_path):
    """`reason --cpu_devices 2 --mesh 1,1,2` takes one step on two
    tensor-parallel ranks; its metrics equal the one-device CLI's (1e-5)."""
    from bioreason_tpu_torch.cli import reason
    argv = ["--decoder", "tiny", "--encoder", "tiny", "--device", "cpu", "--seed", "3",
            "--num_generations", "2", "--batch_size", "4", "--max_steps", "1",
            "--max_completion_length", "4", "--max_length_dna", "64", "--n_synthetic", "16"]
    mesh = reason.main(argv + ["--cpu_devices", "2", "--mesh", "1,1,2", "--checkpoint_dir",
                               str(tmp_path / "m"), "--log_dir", str(tmp_path / "ml")])
    one = reason.main(argv + ["--checkpoint_dir", str(tmp_path / "o"), "--log_dir",
                              str(tmp_path / "ol")])
    assert len(mesh.metrics_history) == 1
    for k in ("loss", "kl", "reward", "grad_norm"):
        assert math.isfinite(mesh.metrics_history[0][k])
        assert mesh.metrics_history[0][k] == pytest.approx(one.metrics_history[0][k],
                                                           rel=1e-5, abs=1e-7), k
    assert (tmp_path / "m" / "grpo_final" / "state.pt").exists()


def test_train_sft_cli_test_generative_under_mesh_1_1_2(tmp_path):
    """`train_sft --cpu_devices 2 --mesh 1,1,2 --test_generative` (refused
    before): one step, then the generative test through the engine on the
    ranks' shards; its generations equal the one-device CLI's and rank 0
    alone writes the CSV."""
    from bioreason_tpu_torch.cli import train_sft
    argv = ["--decoder", "tiny", "--encoder", "tiny", "--device", "cpu", "--max_steps", "1",
            "--max_length_dna", "64", "--batch_size", "4", "--lora_dropout", "0",
            "--n_synthetic", "20", "--test_generative", "--max_new_tokens", "4"]
    mesh = train_sft.main(argv + ["--cpu_devices", "2", "--mesh", "1,1,2",
                                  "--checkpoint_dir", str(tmp_path / "m")])
    one = train_sft.main(argv + ["--checkpoint_dir", str(tmp_path / "o")])
    assert len(mesh.history) == 1
    assert mesh.history[0]["loss"] == pytest.approx(one.history[0]["loss"], rel=1e-5)
    got = [g["generation"] for g in mesh.test_result.generations]
    assert got and got == [g["generation"] for g in one.test_result.generations]
    assert (tmp_path / "m" / "test_generations.csv").exists()
    # the ranks trained a split table and projection; sft_final, loaded on
    # one device, holds them whole and equal to the one-device run's
    from bioreason_tpu_torch.train.checkpoint import rebuild_sft
    loaded = [dict(rebuild_sft(str(tmp_path / run / "sft_final"), device="cpu")[1]
                   .named_parameters()) for run in ("m", "o")]
    for name in ("decoder.embed.weight", "dna_projection.weight", "dna_projection.bias"):
        a, b = loaded[0][name], loaded[1][name]
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.detach().float().numpy(), b.detach().float().numpy(),
                                   atol=1e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("mesh", ["1,1,2", "1,2,1"])
def test_reason_cli_rollout_int8_under_a_mesh(tmp_path, mesh):
    """`reason --rollout_int8 --rollout_kv_int8 --cpu_devices 2 --mesh <m>`
    takes two steps on the int8 rollout copy, whole on both ranks; at
    (1, 1, 2) its metrics equal the one-device CLI's (1e-5; at (1, 2, 1)
    each data index draws its own samples, so they are only finite). Rank
    0's grpo_final restores into the one-device trainer: its adapters
    equal the checkpoint's, and at (1, 1, 2) the one-device run's own
    (1e-5)."""
    from bioreason_tpu_torch.cli import reason
    from bioreason_tpu_torch.train.checkpoint import load_checkpoint
    argv = ["--decoder", "tiny", "--encoder", "tiny", "--device", "cpu", "--seed", "3",
            "--num_generations", "2", "--batch_size", "4", "--max_steps", "2",
            "--max_completion_length", "4", "--max_length_dna", "64", "--n_synthetic", "16",
            "--rollout_int8", "--rollout_kv_int8"]
    got = reason.main(argv + ["--cpu_devices", "2", "--mesh", mesh, "--checkpoint_dir",
                              str(tmp_path / "m"), "--log_dir", str(tmp_path / "ml")])
    one = reason.main(argv + ["--checkpoint_dir", str(tmp_path / "o"), "--log_dir",
                              str(tmp_path / "ol")])
    assert one.cfg.rollout_kv_int8 and one.engine.kv_int8
    assert len(got.metrics_history) == 2
    for g, w in zip(got.metrics_history, one.metrics_history):
        for k in ("loss", "kl", "reward", "grad_norm"):
            assert math.isfinite(g[k]), k
            if mesh == "1,1,2":
                assert g[k] == pytest.approx(w[k], rel=1e-5, abs=1e-7), k
    path = str(tmp_path / "m" / "grpo_final")
    saved = load_checkpoint(path)["trainable"]
    own = {k: v.detach().clone() for k, v in one.trainable_state().items()}
    one.restore(path)
    assert one.step_count == 2 and set(saved) == set(own)
    for k, v in one.trainable_state().items():
        np.testing.assert_array_equal(v.detach().numpy(), saved[k].numpy(), err_msg=k)
        if mesh == "1,1,2":
            np.testing.assert_allclose(v.detach().numpy(), own[k].numpy(), atol=1e-5,
                                       err_msg=k)
