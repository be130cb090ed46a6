"""FSDP's per-layer gather (bioreason_tpu_torch/parallel/partition.py
`layer_gathered`, comm.py `regathered_saves`) in worlds of gloo ranks on
the CPU, fp32, at tiny widths: each tower layer, table and projection
gathers its fsdp shards while it runs and frees them after, in the forward,
in a remat layer's recompute and for the backward's reads, as each
iteration of JAX's layer scan gathers its layer's slice.

  * SFT at (1, 2, 1) and (2, 2, 1) under remat off, `full` and `dots`: two
    steps' losses and grad-norms (rel 1e-5), the first step's gradients
    and the trained leaves after two steps (1e-5) against one device from
    the same weights, and the losses and grad-norms against the JAX
    SFTTrainer on the same mesh (rel 1e-5);
  * the gathered bytes alive on a rank (`partition.GATHERED`) stay within
    two layers' gathered parameters plus the largest parameter outside the
    layers (the k-mer table), in the forward and in the backward, with both
    towers trained at four layers; the same count over the whole gather
    (`MeshRun.scope(whole=True)`, the engine's) exceeds that bound;
  * a GRPO update and its reference / old logp passes at (1, 2, 1) against
    one device and the JAX GRPOTrainer on the same mesh;
  * the classifier with its encoder trained at (1, 2, 1), the MoE's full
    finetune at (1, 2, 2) (its banks gathered a layer at a time) and GPipe
    at (1, 2, 2) with the encoder sharded over fsdp, against one device.

The JAX trees reach the ranks through a pickle file; the JAX runs are
compiled once per process (`functools.lru_cache`)."""

import dataclasses
import functools
import pickle

import numpy as np
import pytest
import torch

import test_torch_parallel_train as PT
import test_torch_tp_generate as TG
from test_torch_mesh import spawn_world

torch.set_num_threads(1)

REMATS = ("off", "full", "dots")
SFT_MESHES = {2: (1, 2, 1), 4: (2, 2, 1)}


def with_remat(fcfg, remat: str, layers: int = 0):
    """Both towers' remat set to `remat` ("off", "full", "dots"); `layers`:
    their depth, if given."""
    def tower(c):
        c = dataclasses.replace(c, remat=remat != "off", remat_policy=(
            "dots" if remat == "dots" else "full"))
        return dataclasses.replace(c, num_layers=layers) if layers else c
    return dataclasses.replace(fcfg, decoder=tower(fcfg.decoder), encoder=tower(fcfg.encoder))


def whole_grads(tr, shards):
    """{name: whole gradient} from `DistAdamW.reduce`'s shards (ZeRO-2 pieces
    gathered over 'data', then the model / fsdp pieces)."""
    from bioreason_tpu_torch.parallel import comm
    from bioreason_tpu_torch.parallel.trainer import full_named
    data = tr.run.topo.data
    return full_named(tr.run, {n: g if z is None else comm.all_gather(g, data, z)
                               for n, g, z in zip(tr.names, shards, tr.opt.zdim)})


def sft_steps(jparams, remat: str, mesh=None):
    """Two SFT steps from the JAX trainer's weights: metrics, the trained
    leaves after them and the first step's gradients (whole, summed)."""
    from bioreason_tpu_torch.train.sft import SFTTrainer
    fcfg, scfg, batches = PT.sft_setup()
    tr = SFTTrainer(with_remat(fcfg, remat), scfg, device="cpu", mesh=mesh,
                    model=PT.jax_model(jparams))
    first = []
    if mesh is None:
        real = tr.loss_and_grads

        def capture(db):
            loss, grads = real(db)
            first.append(dict(zip(tr.names, grads)))
            return loss, grads
        tr.loss_and_grads = capture
    else:
        reduce = tr.opt.reduce

        def capture(grads):
            shards = reduce(grads)
            first.append(whole_grads(tr, shards))
            return shards
        tr.opt.reduce = capture
    metrics = [tr.train_step(b) for b in batches]
    state = {k: v.detach().numpy() for k, v in tr.trainable_state().items()}
    return metrics, state, {k: v.detach().numpy() for k, v in first[0].items()}


def gathered_bytes(mesh, remat: str, whole: bool = False):
    """One SFT step's forward and backward with both towers trained at four
    layers: the most gathered bytes alive on this rank in each, and the
    plan's reckoning (per gather unit) of what gathers hold."""
    from bioreason_tpu_torch.parallel.partition import GATHERED
    from bioreason_tpu_torch.train.sft import SFTTrainer
    fcfg, scfg, batches = PT.sft_setup(freeze_encoder=False)
    tr = SFTTrainer(with_remat(fcfg, remat, layers=4), scfg, device="cpu", mesh=mesh)
    sizes = tr.run.plan.gather_sizes(tr.model)
    db = tr._device_batch(batches[0])
    GATHERED.reset()
    with tr.run.scope(whole=whole):
        loss = tr._loss(db, train=True)
        fwd = GATHERED.high
        GATHERED.reset()
        torch.autograd.grad(loss, tr.params, allow_unused=True)
        bwd = GATHERED.high
    return {"fwd": fwd, "bwd": bwd, "sizes": sizes}


def grpo_case(jparams, buf, mesh=None):
    """The reference and old logp passes on the fixed buffer (every row,
    gathered from the ranks'), then two updates: (ref, old, metrics, the
    trained leaves after them)."""
    from bioreason_tpu_torch.train.grpo import per_token_logps
    tr = TG.port_grpo(jparams, mesh)
    rows = (lambda x: x) if mesh is None else tr.run.rows
    batch = {k: None if v is None else torch.as_tensor(rows(np.asarray(v)))
             for k, v in buf.items()}
    args = (tr.fusion_cfg, batch["full_ids"], batch["full_mask"], batch["dna_input_ids"],
            batch["dna_attention_mask"], TG.CLEN)
    logps = {}
    with torch.no_grad():
        for name, model in (("ref", tr.ref_model), ("old", tr.model)):
            with tr._gathered(model):
                lp = per_token_logps(model, *args)
            logps[name] = (lp if mesh is None else tr.run.gather_rows(lp)).numpy()
    metrics, state = TG.grpo_updates(jparams, buf, mesh)
    return logps["ref"], logps["old"], metrics, state


def classifier_case(mesh=None):
    """`PT.classifier_steps` (the encoder trained) and the most gathered
    bytes alive on this rank."""
    from bioreason_tpu_torch.parallel.partition import GATHERED
    GATHERED.reset()
    return PT.classifier_steps(mesh), GATHERED.high


def moe_full_case(mesh=None):
    """The tiny MoE fully finetuned for two steps (`PT.sft_run`) and the most
    gathered bytes alive on this rank."""
    from bioreason_tpu_torch.parallel.partition import GATHERED
    GATHERED.reset()
    got = PT.sft_run(mesh, moe=True, full=True)[:2]
    return got, GATHERED.high


def _world(rank, world, tree_file):
    from bioreason_tpu_torch.config import MeshConfig
    from bioreason_tpu_torch.parallel.mesh import make_mesh
    with open(tree_file, "rb") as f:
        trees = pickle.load(f)
    mesh = make_mesh(MeshConfig(*SFT_MESHES[world]), device="cpu")
    out = {"sft": {r: sft_steps(trees["sft"], r, mesh) for r in REMATS}}
    if world == 2:
        out["bytes"] = {r: gathered_bytes(mesh, r) for r in REMATS}
        out["bytes"]["whole"] = gathered_bytes(mesh, "off", whole=True)
        out["grpo"] = grpo_case(trees["grpo"], trees["buf"], mesh)
        out["classifier"] = classifier_case(mesh)
    else:
        m122 = make_mesh(MeshConfig(1, 2, 2), device="cpu")
        out["moe_full"] = moe_full_case(m122)
        out["moe_sizes"] = moe_sizes(m122)
        out["gpipe"] = gpipe_steps(m122)
    return out


def moe_sizes(mesh):
    """The plan's reckoning of the fully finetuned MoE's gathers."""
    from bioreason_tpu_torch.train.sft import SFTTrainer
    fcfg, scfg, _ = PT.sft_setup(moe=True, full=True)
    tr = SFTTrainer(fcfg, scfg, device="cpu", mesh=mesh)
    return tr.run.plan.gather_sizes(tr.model)


def gpipe_steps(mesh=None):
    """Two SFT steps with GPipe over 'model' (pp_micro 2) where a mesh is
    given: metrics and the trained leaves."""
    from bioreason_tpu_torch.train.sft import SFTTrainer
    fcfg, scfg, batches = PT.sft_setup()
    tr = SFTTrainer(fcfg, dataclasses.replace(scfg, pp_micro=2 if mesh else 0), device="cpu",
                    mesh=mesh)
    metrics = [tr.train_step(b) for b in batches]
    return metrics, {k: v.detach().numpy() for k, v in tr.trainable_state().items()}


@functools.lru_cache(maxsize=None)
def jax_grpo_121():
    """The JAX GRPOTrainer at (1, 2, 1) from the SFT trainer's initial tree:
    (its initial tree, the fixed buffer with its noisy reference logps,
    its first step's metrics)."""
    return TG.run_jax_grpo(PT.jax_sft()[0], SFT_MESHES[2])


def _spawn(world, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(f"fsdp{world}")
    trees = {"sft": PT.jax_sft()[0]}
    if world == 2:
        init, buf, _ = jax_grpo_121()
        trees.update(grpo=init, buf=buf)
    path = tmp / "trees.pkl"
    with open(path, "wb") as f:
        pickle.dump(trees, f)
    return spawn_world(_world, world, tmp, str(path))


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _spawn(2, tmp_path_factory)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _spawn(4, tmp_path_factory)


@functools.lru_cache(maxsize=None)
def one_device(remat: str):
    return sft_steps(PT.jax_sft()[0], remat)


def _same_steps(got, want):
    """Losses and grad-norms (rel 1e-5), the trained leaves after two steps
    and the first step's gradients (1e-5) of two `sft_steps`."""
    for m, r in zip(got[0], want[0]):
        assert m["loss"] == pytest.approx(r["loss"], rel=1e-5)
        assert m["grad_norm"] == pytest.approx(r["grad_norm"], rel=1e-5)
    for i in (1, 2):
        assert set(got[i]) == set(want[i])
        for k in want[i]:
            np.testing.assert_allclose(got[i][k], want[i][k], atol=1e-5, rtol=0, err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("remat", REMATS)
def test_sft_matches_one_device_and_jax(request, world, remat):
    """SFT at (1, 2, 1) or (2, 2, 1) on per-layer gathers under each remat
    setting: every rank against one device from the same weights (two
    steps, first-step gradients), and the losses and grad-norms against
    the JAX SFTTrainer on the same mesh (the (2, 2, 1) trainer's first
    step; two steps of the (1, 2, 1) one)."""
    res = request.getfixturevalue(f"world{world}")
    jm = ([PT.jax_sft()[1]] if world == 4
          else PT.jax_sft(SFT_MESHES[2], steps=2, params=True)[1])
    for r in res:
        _same_steps(r["sft"][remat], one_device(remat))
        for m, j in zip(r["sft"][remat][0], jm):
            assert m["loss"] == pytest.approx(float(j["loss"]), rel=1e-5)
            assert m["grad_norm"] == pytest.approx(float(j["grad_norm"]), rel=1e-5)


def _bound(sizes):
    """Two of the largest layer's gathered bytes plus the largest parameter
    outside the layers, and what a whole gather holds."""
    layers = [n for k, n in sizes.items() if ".layers." in k]
    outside = [n for k, n in sizes.items() if ".layers." not in k]
    return 2 * max(layers) + max(outside), sum(sizes.values())


@pytest.mark.parametrize("remat", REMATS)
def test_gathered_bytes_stay_within_two_layers(world2, remat):
    """Both towers trained at four layers, fsdp 2: the gathered bytes alive
    on each rank never exceed two layers' plus the table's, in the forward
    or in the backward (with remat, its recompute)."""
    for r in world2:
        got = r["bytes"][remat]
        bound, whole = _bound(got["sizes"])
        assert 0 < got["fwd"] <= bound
        assert 0 < got["bwd"] <= bound
        assert whole > bound


def test_whole_gather_exceeds_the_bound(world2):
    """The same count over `MeshRun.scope(whole=True)` (the engine's whole gather)
    holds every layer at once: above the per-layer bound, at the plan's
    whole reckoning."""
    for r in world2:
        got = r["bytes"]["whole"]
        bound, whole = _bound(got["sizes"])
        assert got["fwd"] > bound
        assert got["fwd"] >= whole


def test_grpo_logps_and_update_match_one_device_and_jax(world2):
    """At (1, 2, 1): the reference and old logp passes (every row, 1e-5)
    against one device and the reference against the JAX trainer's (its
    buffer's noise taken off); two updates' loss, kl and grad-norm (rel
    1e-5) and the adapters (1e-5) against one device, the first loss
    against the JAX trainer on the same mesh."""
    init, buf, jm = jax_grpo_121()
    noise = np.random.default_rng(12).standard_normal(buf["ref_logps"].shape) * 0.3
    jref = buf["ref_logps"] - noise.astype(np.float32)
    want_ref, want_old, want_m, want_s = grpo_case(init, buf)
    np.testing.assert_allclose(want_ref, jref, atol=1e-5, rtol=0)
    for r in world2:
        ref, old, got_m, got_s = r["grpo"]
        np.testing.assert_allclose(ref, want_ref, atol=1e-5, rtol=0)
        np.testing.assert_allclose(old, want_old, atol=1e-5, rtol=0)
        np.testing.assert_allclose(ref, jref, atol=1e-5, rtol=0)
        assert got_m[0]["loss"] == pytest.approx(float(jm["loss"]), rel=1e-5, abs=1e-7)
        for g, w in zip(got_m, want_m):
            for k in ("loss", "kl", "grad_norm"):
                assert g[k] == pytest.approx(w[k], rel=1e-5, abs=1e-7), k
        for k in want_s:
            np.testing.assert_allclose(got_s[k], want_s[k], atol=1e-5, rtol=0, err_msg=k)


def test_classifier_with_encoder_trained_matches_one_device(world2):
    """ClassifierTrainer(train_just_classifier=False) at (1, 2, 1): losses,
    metrics and every trained parameter after two steps (1e-5) against one
    device; no more than the k-mer table and two encoder layers gathered
    at once."""
    want_m, want_s = PT.classifier_steps()
    layer = sum(v.size for k, v in want_s.items() if k.startswith("encoder.layers.0.")
                and v.ndim == 2) * 4
    table = want_s["encoder.embed.weight"].size * 4
    for r in world2:
        (got_m, got_s), high = r["classifier"]
        for g, w in zip(got_m, want_m):
            assert g["loss"] == pytest.approx(w["loss"], rel=1e-5)
            assert g["accuracy"] == w["accuracy"] and g["f1"] == pytest.approx(w["f1"])
        for k in want_s:
            np.testing.assert_allclose(got_s[k], want_s[k], atol=1e-5, rtol=0, err_msg=k)
        assert 0 < high <= 2 * layer + table


def test_moe_full_finetune_gathers_banks_per_layer(world4):
    """The tiny MoE with every decoder weight trained at (1, 2, 2): its
    banks split over 'model' and 'fsdp'; losses, grad-norms and every
    parameter after two steps against one device (1e-5), and no rank holds
    more than two layers' gathered banks and weights plus the table."""
    want = PT.one_device(moe=True, full=True)
    for r in world4:
        got, high = r["moe_full"]
        PT._same_run(got, want)
        bound, whole = _bound(r["moe_sizes"])
        assert 0 < high <= bound < whole


def test_gpipe_with_fsdp_matches_one_device(world4):
    """GPipe over 'model' (pp_micro 2) at (1, 2, 2), the encoder's layers,
    its table and the projection sharded over fsdp and gathered per layer
    in each stage's ticks: losses, grad-norms and the trained leaves after
    two steps against one device (1e-5)."""
    want_m, want_s = gpipe_steps()
    for r in world4:
        got_m, got_s = r["gpipe"]
        for a, b in zip(got_m, want_m):
            assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)
            assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=1e-5)
        for k in want_s:
            np.testing.assert_allclose(got_s[k], want_s[k], atol=1e-5, rtol=0, err_msg=k)
