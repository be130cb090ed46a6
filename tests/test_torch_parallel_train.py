"""The port's trainers under a mesh (bioreason_tpu_torch/parallel/
trainer.py, partition.py) in worlds of gloo ranks on the CPU, fp32: two SFT
steps at meshes (2,2,1), (1,2,2) and (2,1,2) against the one-device step
(loss and grad-norm 1e-5 relative, every trained parameter 1e-5) and their
first loss against the JAX SFTTrainer on the same mesh shape (1e-5; the
port's weights come from the JAX trainer's), ZeRO-2's moments sharded over
'data', the tiny MoE with model=2 (expert and tensor parallelism) and
data=2 (the capacity over the global batch), the MoE fully finetuned with
its banks sharded, a GRPO update and a
classifier step at data=2 against one device, and `train_sft --cpu_devices
4 --mesh 2,2,1` for one step. In the world of two: QLoRA under fsdp 2
(1, 2, 1), its int8 weights whole on both ranks as JAX places them (two
SFT steps against one device and the first against the JAX
SFTTrainer(frozen_dtype="int8") on the same mesh; two GRPO updates with
`rollout_int8` against one device and the JAX trainer; the rollout copy of
a float tree bitwise one device's), and the focal CE split over data and
over fsdp, two steps against the JAX SFTTrainer(focal_gamma=2.0) on the
same mesh. LoRA dropout is 0: a rank draws the masks of
its own rows. The mesh runs recompute their layers in the backward (remat),
the one-device reference does not: the values are the same."""

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

from test_torch_mesh import spawn_world

torch.set_num_threads(1)

MESHES = [(2, 2, 1), (1, 2, 2), (2, 1, 2)]


def sft_setup(enc_impl=None, freeze_encoder=True, moe=False, batch=4, remat=False,
              full=False):
    """(port FusionConfig, SFTConfig, two global batches) at tiny widths;
    `remat` recomputes both towers' layers in the backward; `full` trains
    every decoder weight (no LoRA)."""
    from bioreason_tpu_torch import config as TC
    from bioreason_tpu_torch.data import BioProcessor, ByteTextTokenizer, KmerTokenizer
    from bioreason_tpu_torch.data import collate as TD
    from bioreason_tpu_torch.data import kegg as TK
    tok = ByteTextTokenizer()
    fcfg = TC.FusionConfig.tiny(text_vocab=tok.vocab_size, dna_pad_token_id=tok.dna_pad_id)
    dec = TC.DecoderConfig.tiny_moe(tok.vocab_size) if moe else fcfg.decoder
    fcfg = dataclasses.replace(fcfg, decoder=dataclasses.replace(dec, head_dim=64, remat=remat),
                               encoder=dataclasses.replace(fcfg.encoder, remat=remat))
    if enc_impl:
        fcfg = dataclasses.replace(fcfg, encoder=dataclasses.replace(
            fcfg.encoder, attention_impl=enc_impl))
    scfg = TC.SFTConfig(batch_size=batch, max_length_dna=64, bucket=None, frozen_dtype="",
                        freeze_encoder=freeze_encoder,
                        optim=TC.OptimConfig(learning_rate=1e-2, total_steps=20,
                                             warmup_ratio=0.0, eps=1e-3),
                        lora=None if full else TC.LoRAConfig(r=4, alpha=8, dropout=0.0))
    proc = BioProcessor(tok, KmerTokenizer())
    batches = []
    for seed in (10, 11):
        exs = [TK.format_kegg_for_dna_llm(it)
               for it in TK.synthetic_kegg_items(batch, seq_len=240, seed=seed)]
        batches.append(TD.sft_collate(exs, proc, 512, 64, bucket=None))
    return fcfg, scfg, batches


def sft_run(mesh=None, moe=False, model=None, remat=False, full=False, pieces=None, **kw):
    """Two steps: metrics, the final trainable parameters (whole) and, under
    a mesh, each moment's local shape against its parameter's. `pieces` (a
    dict): filled with this rank's pieces of the table and the projection
    (`split_pieces`). `kw`: other SFTConfig fields (frozen_dtype,
    focal_gamma)."""
    from test_torch_tp_generate import split_pieces
    from bioreason_tpu_torch.train.sft import SFTTrainer
    fcfg, scfg, batches = sft_setup(moe=moe, remat=remat, full=full)
    tr = SFTTrainer(fcfg, dataclasses.replace(scfg, **kw), device="cpu", mesh=mesh,
                    model=model)
    metrics = [tr.train_step(b) for b in batches]
    state = {k: v.detach().numpy() for k, v in tr.trainable_state().items()}
    shapes = None
    if mesh is not None:
        shapes = {n: (tuple(p.shape), tuple(mu.shape), z)
                  for n, p, mu, z in zip(tr.names, tr.params, tr.opt.mu, tr.opt.zdim)}
    if pieces is not None:
        pieces.update(split_pieces(tr.model))
    return metrics, state, shapes


def jax_model(jparams):
    from bioreason_tpu_torch.weights import from_jax_params
    fcfg, _, _ = sft_setup()
    return from_jax_params(jparams, fcfg, device="cpu")


def _train_world(rank, world, jparams):
    from bioreason_tpu_torch.config import MeshConfig
    from bioreason_tpu_torch.parallel.mesh import make_mesh
    out = {"pieces": {}}
    piece = lambda label: out["pieces"].setdefault(label, {})
    for c in MESHES:          # remat on: the backward recomputes under the scope
        out[c] = sft_run(make_mesh(MeshConfig(*c), device="cpu"), remat=True, pieces=piece(c))
    out["moe"] = sft_run(make_mesh(MeshConfig(2, 1, 2), device="cpu"), moe=True,
                         pieces=piece("moe"))
    out["moe_full"] = sft_run(make_mesh(MeshConfig(1, 2, 2), device="cpu"), moe=True, full=True,
                              pieces=piece("moe_full"))
    out["jax"] = sft_run(make_mesh(MeshConfig(2, 2, 1), device="cpu"), model=jax_model(jparams))
    return out


@functools.lru_cache(maxsize=None)
def jax_sft(mesh_shape=(2, 2, 1), steps=1, params=False, **kw):
    """The JAX SFTTrainer on a mesh of the CPU devices (`kw`: its other
    SFTConfig fields; `params`: start from the (2, 2, 1) trainer's initial
    parameters, else draw them from its seed): its initial parameters and
    the metrics of its first `steps` steps on the global batches."""
    import jax
    from bioreason_tpu import config as JC
    from bioreason_tpu.parallel import make_mesh
    from bioreason_tpu.train.sft import SFTTrainer as JTrainer
    fcfg, scfg, batches = sft_setup()
    jf = JC.FusionConfig(**{
        **{f.name: getattr(JC.FusionConfig.tiny(), f.name)
           for f in dataclasses.fields(JC.FusionConfig)},
        "decoder": JC.DecoderConfig(**dataclasses.asdict(fcfg.decoder)),
        "encoder": JC.EncoderConfig(**dataclasses.asdict(fcfg.encoder)),
        "dna_pad_token_id": fcfg.dna_pad_token_id})
    js = JC.SFTConfig(**{"batch_size": 4, "max_length_dna": 64, "bucket": None,
                         "frozen_dtype": "",
                         "optim": JC.OptimConfig(learning_rate=1e-2, total_steps=20,
                                                 warmup_ratio=0.0, eps=1e-3),
                         "lora": JC.LoRAConfig(r=4, alpha=8, dropout=0.0), **kw})
    n = int(np.prod(mesh_shape))
    tr = JTrainer(jf, js, mesh=make_mesh(JC.MeshConfig(*mesh_shape), devices=jax.devices()[:n]),
                  params=jax_sft()[0] if params else None)
    init = jax.tree.map(np.asarray, tr.params)
    metrics = [tr.train_step(b) for b in batches[:steps]]
    return init, metrics[0] if steps == 1 else metrics


@pytest.fixture(scope="module")
def train_world(tmp_path_factory):
    jparams, _ = jax_sft()
    return spawn_world(_train_world, 4, tmp_path_factory.mktemp("train4"), jparams)


@functools.lru_cache(maxsize=None)
def one_device(moe=False, full=False):
    return sft_run(moe=moe, full=full)


def _same_run(got, want):
    for m, r in zip(got[0], want[0]):
        assert m["loss"] == pytest.approx(r["loss"], rel=1e-5)
        assert m["grad_norm"] == pytest.approx(r["grad_norm"], rel=1e-5)
        assert m["lr"] == r["lr"]
    assert set(got[1]) == set(want[1])
    for k in want[1]:
        np.testing.assert_allclose(got[1][k], want[1][k], atol=1e-5, rtol=0, err_msg=k)


@pytest.mark.parametrize("mesh", MESHES)
def test_sft_steps_on_a_mesh_match_one_device(train_world, mesh):
    """Every rank reports the global loss and grad-norm; rank 0's gathered
    parameters equal the one-device trainer's."""
    for res in train_world:
        _same_run(res[mesh], one_device())


def test_sft_loss_on_a_mesh_matches_jax(train_world):
    """The first step's loss and grad-norm at (2, 2, 1) against the JAX
    trainer's on its (2, 2, 1) CPU mesh, from the same weights."""
    _, jm = jax_sft()
    m = train_world[0]["jax"][0][0]
    assert m["loss"] == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert m["grad_norm"] == pytest.approx(float(jm["grad_norm"]), rel=1e-5)


@pytest.mark.parametrize("mesh", MESHES)
def test_zero2_moments_are_sharded_over_data(train_world, mesh):
    """Each moment holds 1/data of its (fsdp / tensor-parallel) parameter
    piece along the first dim data divides, as JAX zero2_sharding picks it;
    the fsdp-sharded and tensor-parallel pieces are smaller than the whole."""
    d, f, m = mesh
    full = {k: v.shape for k, v in one_device()[1].items()}
    n_sharded = 0
    for name, (pshape, mshape, z) in train_world[0][mesh][2].items():
        want = list(pshape)
        if d > 1 and z is not None:
            want[z] //= d
            n_sharded += 1
        assert list(mshape) == want, name
        if d > 1:
            assert z == next((i for i, s in enumerate(pshape) if s % d == 0 and s >= d), None)
    assert n_sharded > 0 or d == 1
    if f * m > 1:
        assert any(np.prod(ps) < np.prod(full[n])
                   for n, (ps, _, _) in train_world[0][mesh][2].items())


@pytest.mark.parametrize("label", [(1, 2, 2), (2, 1, 2), "moe", "moe_full"])
def test_ranks_hold_their_table_and_projection_rows(train_world, label):
    """At model 2 every rank stores [V/2, H/f] rows of the decoder's table,
    marked vocab-parallel, and [H/2, D/f] of the DNA projection: the SFT
    parity tests of these worlds run the split head, CE and projection
    (the fully finetuned MoE trains its table split over both axes)."""
    mesh = {"moe": (2, 1, 2), "moe_full": (1, 2, 2)}.get(label, label)
    _, f, m = mesh
    fcfg, _, _ = sft_setup(moe=str(label).startswith("moe"))
    v, h, d = fcfg.decoder.vocab_size, fcfg.decoder.hidden_size, fcfg.encoder.hidden_size
    for res in train_world:
        assert res["pieces"][label] == {"table": (v // m, h // f), "vocab_split": True,
                                        "projection": (h // m, d // f)}
    if label == "moe_full":
        assert "decoder.embed.weight" in train_world[0][label][2]


def test_moe_with_model_2_matches_one_device(train_world):
    """The tiny MoE (E=4, k=2) at (2, 1, 2): experts split over 'model',
    attention heads too, rows over 'data' with the capacity counted over
    the global batch, against one device."""
    for res in train_world:
        _same_run(res["moe"], one_device(moe=True))


def test_moe_full_finetune_sharded_matches_one_device(train_world):
    """Every decoder weight trained (no LoRA) at (1, 2, 2): the expert banks
    split over 'model' and 'fsdp', the attention's colwise / rowwise
    weights over 'model', the embedding over 'fsdp', ZeRO-2 off (data 1);
    losses, grad-norms and every parameter after two steps against one
    device (1e-5)."""
    for res in train_world:
        _same_run(res["moe_full"], one_device(moe=True, full=True))


# -- GRPO and the classifier at data=2 --------------------------------------------------

def grpo_update(mesh=None):
    """Two `_update` micro-steps of the tiny GRPO trainer on one fixed
    rollout buffer (seeded numpy), each rank on its rows."""
    from bioreason_tpu_torch import config as TC
    from bioreason_tpu_torch.data import BioProcessor, ByteTextTokenizer, KmerTokenizer
    from bioreason_tpu_torch.train.grpo import GRPOTrainer
    from bioreason_tpu_torch.train.rewards import correctness_reward
    tok = ByteTextTokenizer()
    fcfg = TC.FusionConfig.tiny(text_vocab=tok.vocab_size, dna_pad_token_id=tok.dna_pad_id)
    cfg = TC.GRPOConfig(num_generations=2, batch_size=4, beta=0.04, max_completion_length=6,
                        optim=TC.OptimConfig(learning_rate=1e-2, total_steps=10,
                                             warmup_ratio=0.0, eps=1e-3),
                        lora=TC.LoRAConfig(r=4, alpha=8, dropout=0.0), frozen_dtype="")
    tr = GRPOTrainer(fcfg, cfg, BioProcessor(tok, KmerTokenizer()), [correctness_reward],
                     device="cpu", mesh=mesh)
    rng = np.random.default_rng(3)
    b, p, c = 4, 10, 6
    full_ids = rng.integers(5, 250, (b, p + c))
    full_mask = np.ones((b, p + c), np.int64)
    full_mask[1, :3] = 0
    cmask = np.ones((b, c), np.int64)
    cmask[2, 4:] = 0
    adv = rng.standard_normal(b).astype(np.float32)
    rows = (lambda x: x) if mesh is None else tr.run.rows
    batch = {"full_ids": torch.tensor(rows(full_ids)), "full_mask": torch.tensor(rows(full_mask)),
             "completion_mask": torch.tensor(rows(cmask)), "dna_input_ids": None,
             "dna_attention_mask": None, "advantages": torch.tensor(rows(adv))}
    with torch.no_grad(), tr._gathered(tr.ref_model):
        from bioreason_tpu_torch.train.grpo import per_token_logps
        batch["ref_logps"] = per_token_logps(tr.ref_model, fcfg, batch["full_ids"],
                                             batch["full_mask"], None, None, c)
    out = [tr._update(batch, c) for _ in range(2)]
    return out, {k: v.detach().cpu().numpy() for k, v in tr.trainable_state().items()}


def classifier_steps(mesh=None):
    from bioreason_tpu_torch import config as TC
    from bioreason_tpu_torch.train.classifier import ClassifierTrainer
    cfg = TC.EncoderConfig.tiny()
    tr = ClassifierTrainer(cfg, num_classes=3, optim=TC.OptimConfig(
        learning_rate=1e-2, total_steps=10, warmup_ratio=0.0, eps=1e-3),
        train_just_classifier=False, device="cpu", mesh=mesh)
    rng = np.random.default_rng(4)
    out = []
    for _ in range(2):
        ids = rng.integers(5, cfg.vocab_size, (4, 24))
        mask = np.ones((4, 24), np.int64)
        mask[3, 20:] = 0
        batch = {"ref_ids": ids, "alt_ids": np.where(ids % 7 == 0, 6, ids),
                 "ref_attention_mask": mask, "alt_attention_mask": mask,
                 "labels": rng.integers(0, 3, 4)}
        out.append(tr.train_step(batch))
    state = dict(zip(tr.names, tr.params))
    if mesh is not None:
        from bioreason_tpu_torch.parallel.trainer import full_named
        state = full_named(tr.run, state)
    return out, {n: p.detach().cpu().numpy() for n, p in state.items()}


DATA2 = {"data": (2, 1, 1), "fsdp": (1, 2, 1)}
FOCAL = 2.0


# the QLoRA SFT case at (1, 2, 1) also takes the focal CE: one JAX trainer,
# SFTTrainer(frozen_dtype="int8", focal_gamma=2.0), holds both
QLORA_SFT = dict(frozen_dtype="int8", focal_gamma=FOCAL)


def _data2_world(rank, world, jparams, buf8):
    import test_torch_tp_generate as TG
    from bioreason_tpu_torch.config import MeshConfig
    from bioreason_tpu_torch.parallel.mesh import make_mesh
    out = {}
    for label, shape in DATA2.items():
        mesh = make_mesh(MeshConfig(*shape), device="cpu")
        out[label] = {"grpo": grpo_update(mesh), "classifier": classifier_steps(mesh)}
    out["data"]["focal"] = sft_run(make_mesh(MeshConfig(*DATA2["data"]), device="cpu"),
                                   model=jax_model(jparams), focal_gamma=FOCAL)
    out["fsdp"].update(
        qlora_sft=sft_run(mesh, model=jax_model(jparams), **QLORA_SFT),
        qlora_grpo=TG.grpo_updates(jparams, buf8, mesh, **TG.QLORA),
        rollout=TG.int8_state(TG.port_grpo(jparams, mesh, rollout_int8=True).rollout_model()))
    return out


@functools.lru_cache(maxsize=None)
def jax_grpo_fsdp():
    """The JAX QLoRA GRPOTrainer (`rollout_int8`) at (1, 2, 1) from the
    SFT trainer's initial tree (fp32; the same LoRA draws): the buffer with
    its reference logps, and the first step's metrics on it."""
    import test_torch_tp_generate as TG
    _, buf8, jm = TG.run_jax_grpo(jax_sft()[0], DATA2["fsdp"], **TG.QLORA)
    return buf8, jm


@pytest.fixture(scope="module")
def data2_world(tmp_path_factory):
    jparams, _ = jax_sft()
    buf8, _ = jax_grpo_fsdp()
    return spawn_world(_data2_world, 2, tmp_path_factory.mktemp("data2"), jparams, buf8)


@pytest.mark.parametrize("axis", ["data", "fsdp"])
def test_grpo_update_at_data_2_matches_one_device(data2_world, axis):
    """Loss, kl and grad-norm of two updates (1e-5 relative) and the
    adapters after them (1e-5), the rows split over 'data' (2, 1, 1) or
    over 'fsdp' (1, 2, 1, the parameters sharded and gathered for the
    logp passes and the update)."""
    want_m, want_s = grpo_update()
    for res in data2_world:
        got_m, got_s = res[axis]["grpo"]
        for g, w in zip(got_m, want_m):
            for k in ("loss", "kl", "grad_norm"):
                assert g[k] == pytest.approx(w[k], rel=1e-5, abs=1e-7), k
        for k in want_s:
            np.testing.assert_allclose(got_s[k], want_s[k], atol=1e-5, rtol=0, err_msg=k)


@pytest.mark.parametrize("axis", ["data", "fsdp"])
def test_classifier_step_at_data_2_matches_one_device(data2_world, axis):
    """Loss and the metrics over the global batch, and every trained
    parameter after two steps (1e-5), over 'data' or 'fsdp' (the encoder
    sharded)."""
    want_m, want_s = classifier_steps()
    for res in data2_world:
        got_m, got_s = res[axis]["classifier"]
        for g, w in zip(got_m, want_m):
            assert g["loss"] == pytest.approx(w["loss"], rel=1e-5)
            assert g["accuracy"] == w["accuracy"] and g["f1"] == pytest.approx(w["f1"])
        for k in want_s:
            np.testing.assert_allclose(got_s[k], want_s[k], atol=1e-5, rtol=0, err_msg=k)


def test_qlora_sft_at_fsdp_2_matches_one_device_and_jax(data2_world):
    """Two QLoRA SFT steps (with the focal CE) at (1, 2, 1): the int8
    weights whole on both ranks (no fsdp slice, no gather), the adapters,
    norms and projection sharded and gathered; losses, grad-norms and the
    gathered trained leaves against one device (rel 1e-5, atol 1e-5), both
    steps against the JAX SFTTrainer(frozen_dtype="int8", focal_gamma=2.0)
    on its (1, 2, 1) mesh (rel 1e-5)."""
    jparams, _ = jax_sft()
    want = sft_run(model=jax_model(jparams), **QLORA_SFT)
    _, jm = jax_sft(DATA2["fsdp"], steps=2, params=True, **QLORA_SFT)
    for res in data2_world:
        _same_run(res["fsdp"]["qlora_sft"], want)
        for m, j in zip(res["fsdp"]["qlora_sft"][0], jm):
            assert m["loss"] == pytest.approx(float(j["loss"]), rel=1e-5)
            assert m["grad_norm"] == pytest.approx(float(j["grad_norm"]), rel=1e-5)


@pytest.mark.parametrize("axis", ["data", "fsdp"])
def test_focal_ce_over_data_x_fsdp_matches_jax(data2_world, axis):
    """focal_gamma=2 with the rows split over 'data' (2, 1, 1; float frozen
    weights) or 'fsdp' (1, 2, 1; the QLoRA case above): each rank divides
    its weighted CE by the detached weights summed over both ranks, as
    JAX's global sum; two steps' losses and grad-norms against the JAX
    SFTTrainer(focal_gamma=2.0) on the same mesh (rel 1e-5), and against
    the one-device trainer (rel 1e-5, leaves 1e-5)."""
    jparams, _ = jax_sft()
    kw = QLORA_SFT if axis == "fsdp" else {"focal_gamma": FOCAL}
    _, jm = jax_sft(DATA2[axis], steps=2, params=True, **kw)
    want = sft_run(model=jax_model(jparams), **kw)
    for res in data2_world:
        got = res[axis]["qlora_sft" if axis == "fsdp" else "focal"]
        _same_run(got, want)
        for m, j in zip(got[0], jm):
            assert m["loss"] == pytest.approx(float(j["loss"]), rel=1e-5)
            assert m["grad_norm"] == pytest.approx(float(j["grad_norm"]), rel=1e-5)


def test_qlora_grpo_update_at_fsdp_2_matches_one_device_and_jax(data2_world):
    """Two QLoRA updates (`rollout_int8`) at (1, 2, 1) on the JAX trainer's
    buffer, each rank on its rows: loss, kl and grad norm (rel 1e-5, abs
    1e-7) and the adapters (1e-5) against one device, the first loss
    against the JAX trainer on the same mesh."""
    import test_torch_tp_generate as TG
    buf8, jm = jax_grpo_fsdp()
    want_m, want_s = TG.grpo_updates(jax_sft()[0], buf8, None, **TG.QLORA)
    assert data2_world[0]["fsdp"]["qlora_grpo"][0][0]["loss"] == pytest.approx(
        float(jm["loss"]), rel=1e-5, abs=1e-7)
    for res in data2_world:
        got_m, got_s = res["fsdp"]["qlora_grpo"]
        for g, w in zip(got_m, want_m):
            for k in ("loss", "kl", "grad_norm"):
                assert g[k] == pytest.approx(w[k], rel=1e-5, abs=1e-7), k
        for k in want_s:
            np.testing.assert_allclose(got_s[k], want_s[k], atol=1e-5, rtol=0, err_msg=k)


def test_int8_rollout_copy_at_fsdp_2_is_one_devices_bitwise(data2_world):
    """The `rollout_int8` copy of the float tree at (1, 2, 1): each weight
    gathered whole from its fsdp shards before it is quantized, so every
    int8 weight and scale on both ranks equals one device's bit for bit."""
    import test_torch_tp_generate as TG
    want = TG.int8_state(TG.port_grpo(jax_sft()[0], rollout_int8=True).rollout_model())
    for res in data2_world:
        got = res["fsdp"]["rollout"]
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_train_sft_cli_cpu_devices_4_mesh_2_2_1(tmp_path, capsys):
    """`train_sft --cpu_devices 4 --mesh 2,2,1` spawns four gloo ranks and
    takes one step; its loss equals the one-device CLI's (1e-5) and rank 0
    alone writes the checkpoint."""
    from bioreason_tpu_torch.cli import train_sft
    argv = ["--decoder", "tiny", "--encoder", "tiny", "--device", "cpu", "--max_steps", "1",
            "--max_length_dna", "64", "--batch_size", "4", "--lora_dropout", "0"]
    mesh = train_sft.main(argv + ["--checkpoint_dir", str(tmp_path / "m"), "--cpu_devices",
                                  "4", "--mesh", "2,2,1"])
    one = train_sft.main(argv + ["--checkpoint_dir", str(tmp_path / "o")])
    assert mesh.history[0]["loss"] == pytest.approx(one.history[0]["loss"], rel=1e-5)
    a = torch.load(tmp_path / "m" / "sft_final" / "state.pt")
    b = torch.load(tmp_path / "o" / "sft_final" / "state.pt")
    assert set(a["trainable"]) == set(b["trainable"])
    for k in b["trainable"]:
        np.testing.assert_allclose(a["trainable"][k], b["trainable"][k], atol=1e-5, err_msg=k)
