"""The NT tower under the mesh's 'model' axis (parallel/partition.py's
`ShardPlan` with `encoder_cfg`, `layers.tp_dense` on biased linears,
train/classifier.py at model > 1) in worlds of gloo ranks on the CPU, fp32
at tiny widths, one module-scoped world per mesh, (1, 1, 2), (1, 2, 2) and
(2, 1, 2):

  * `encoder_forward` on a rank's shards against one device (1e-5) and
    against the JAX `encoder_forward` (1e-5): SwiGLU with attention biases,
    GELU with MLP biases, `local:8`, and 3 heads (which do not divide 2:
    the attention stays replicated, the MLP still splits); every bias drawn
    non-zero; a rank holds num_heads / m heads and I / m MLP rows;
  * the executed placements of the classifier's parameters against the JAX
    classifier's `^encoder/` rules, and `layers.tp_dense` on a colwise and a
    rowwise biased linear (output and the bias's gradient);
  * at (1, 1, 2): two `ClassifierTrainer` steps, the encoder frozen and
    trained, against one device (loss, grad norm, every trained parameter,
    1e-5) and the first loss against the JAX ClassifierTrainer on a (1, 1, 2)
    JAX CPU mesh (1e-5); an SFT step with the tower trained (remat on):
    every encoder gradient, the colwise biases' included, against one
    device; the engine's greedy tokens against the JAX engine on parameters
    sharded over the same mesh; an `sp` tower and an Evo2 tower left
    replicated (no `tp` marker on their linears); a classifier and an SFT
    checkpoint saved at (1, 1, 2) and loaded on one device to the same
    logits;
  * `train_dna_only --cpu_devices 2 --mesh 1,1,2 --finetune_encoder` for one
    step against the one-device CLI."""

import dataclasses
import functools
import json
import pickle
import re

import numpy as np
import pytest
import torch

from test_torch_mesh import _jax_path, spawn_world

torch.set_num_threads(1)

MESHES = [(1, 1, 2), (1, 2, 2), (2, 1, 2)]
ENC_CASES = ["swiglu_attn_bias", "gelu_mlp_bias", "local", "heads_3"]
CLASSES = 3
NEW = 6                       # the engine's new tokens
OPTIM = dict(learning_rate=1e-2, total_steps=10, warmup_ratio=0.0, eps=1e-3)


def t(x):
    return torch.from_numpy(np.asarray(x))


def enc_cfg(module, case):
    """The tiny encoder config of a case, in the JAX (`module` = its config
    module) or the port's form."""
    cfg = module.EncoderConfig.tiny()
    return {"swiglu_attn_bias": cfg,
            "gelu_mlp_bias": dataclasses.replace(cfg, use_swiglu=False, mlp_bias=True),
            "local": dataclasses.replace(cfg, attention_impl="local:8"),
            "heads_3": dataclasses.replace(cfg, hidden_size=48, num_heads=3,
                                           intermediate_size=96)}[case]


def _with_biases(tree, seed):
    """The tree with every encoder bias drawn N(0, 0.1^2) (the JAX init
    leaves them 0, which would hide a bias added twice or sliced wrongly)."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: (rng.standard_normal(np.shape(v)).astype(np.float32) * 0.1
                        if k == "bias" else walk(v)) for k, v in node.items()}
        return node
    return {**tree, "encoder": walk(tree["encoder"])}


# the JAX trees, drawn once in the test process and handed to the ranks
# (which import no JAX)
_TREES = {}


def classifier_tree(case):
    """A JAX classifier tree (numpy) for a case's encoder, biases drawn."""
    if case not in _TREES:
        import jax
        from bioreason_tpu import config as JC
        from bioreason_tpu.models.classifier import init_classifier
        tree = jax.jit(init_classifier, static_argnums=(1, 2))(
            jax.random.PRNGKey(0), enc_cfg(JC, case), CLASSES)
        _TREES[case] = _with_biases(jax.tree.map(np.asarray, tree), 1)
    return _TREES[case]


@functools.lru_cache(maxsize=None)
def enc_inputs(vocab):
    """ids [4, 24] with right pads in rows 1 and 3."""
    rng = np.random.default_rng(2)
    ids = rng.integers(5, vocab, (4, 24)).astype(np.int32)
    mask = np.ones((4, 24), np.int32)
    mask[1, 17:], mask[3, 9:] = 0, 0
    return ids, mask


def port_encoder_out(case, mesh=None):
    """`encoder_forward` of a case's classifier encoder (one device, or this
    rank of `mesh`), and what the rank holds of layer 0."""
    from bioreason_tpu_torch import config as TC
    from bioreason_tpu_torch.models.nt_encoder import encoder_forward
    from bioreason_tpu_torch.parallel.partition import encoder_local_heads
    from bioreason_tpu_torch.parallel.trainer import MeshRun
    from bioreason_tpu_torch.weights import from_jax_params
    cfg = enc_cfg(TC, case)
    model = from_jax_params(classifier_tree(case), cfg, device="cpu")
    run = None if mesh is None else MeshRun(mesh, model, encoder_cfg=cfg)
    ids, mask = enc_inputs(cfg.vocab_size)
    with torch.no_grad(), (run.scope() if run is not None else torch.no_grad()):
        h = encoder_forward(model.encoder, cfg, t(ids), t(mask))
    lay = model.encoder.layers[0]
    mlp_in = lay.mlp.gate if cfg.use_swiglu else lay.mlp.up
    tp = {n: getattr(m, "tp", (None,))[0] for n, m in
          (("q", lay.attn.q), ("o", lay.attn.o), ("in", mlp_in), ("down", lay.mlp.down))}
    return {"h": h.numpy(), "q_rows": lay.attn.q.weight.shape[0],
            "mlp_rows": mlp_in.weight.shape[0], "tp": tp,
            "heads": encoder_local_heads(cfg, run)}


@functools.lru_cache(maxsize=None)
def jax_encoder_out(case):
    import jax
    from bioreason_tpu import config as JC
    from bioreason_tpu.models.nt_encoder import encoder_forward
    cfg = enc_cfg(JC, case)
    ids, mask = enc_inputs(cfg.vocab_size)
    return np.asarray(jax.jit(encoder_forward, static_argnums=1)(
        classifier_tree(case)["encoder"], cfg, ids, mask))


# -- the classifier ----------------------------------------------------------------

def classifier_batches():
    from bioreason_tpu_torch import config as TC
    vocab = TC.EncoderConfig.tiny().vocab_size
    rng = np.random.default_rng(4)
    out = []
    for _ in range(2):
        ids = rng.integers(5, vocab, (4, 24))
        mask = np.ones((4, 24), np.int64)
        mask[3, 20:] = 0
        out.append({"ref_ids": ids, "alt_ids": np.where(ids % 7 == 0, 6, ids),
                    "ref_attention_mask": mask, "alt_attention_mask": mask,
                    "labels": rng.integers(0, CLASSES, 4)})
    return out


def classifier_steps(finetune, mesh=None):
    """Two steps from the JAX tree: metrics with each step's grad norm, and
    the whole trained parameters after them."""
    from bioreason_tpu_torch import config as TC
    from bioreason_tpu_torch.train.classifier import ClassifierTrainer
    from bioreason_tpu_torch.weights import from_jax_params
    cfg = TC.EncoderConfig.tiny()
    tr = ClassifierTrainer(cfg, CLASSES, optim=TC.OptimConfig(**OPTIM),
                           train_just_classifier=not finetune, device="cpu", mesh=mesh,
                           model=from_jax_params(classifier_tree("swiglu_attn_bias"), cfg,
                                                 device="cpu"))
    norms, step = [], tr.opt.step
    tr.opt.step = lambda grads: norms.append(step(grads)) or norms[-1]
    metrics = [tr.train_step(b) for b in classifier_batches()]
    for m, n in zip(metrics, norms):
        m["grad_norm"] = float(n)
    state = dict(zip(tr.names, tr.params))
    if mesh is not None:
        from bioreason_tpu_torch.parallel.trainer import full_named
        state = full_named(tr.run, state)
    return metrics, {n: p.detach().numpy() for n, p in state.items()}


@functools.lru_cache(maxsize=None)
def jax_classifier_first_loss():
    """The JAX ClassifierTrainer's first loss on a (1, 1, 2) mesh of the CPU
    devices, its encoder placed by `partition_rules_encoder` over 'model'."""
    import jax
    import jax.numpy as jnp
    from bioreason_tpu import config as JC
    from bioreason_tpu.parallel import make_mesh
    from bioreason_tpu.train.classifier import ClassifierTrainer as JTrainer
    tr = JTrainer(JC.EncoderConfig.tiny(), CLASSES, optim=JC.OptimConfig(**OPTIM),
                  train_just_classifier=False,
                  mesh=make_mesh(JC.MeshConfig(data=1, fsdp=1, model=2),
                                 devices=jax.devices()[:2]),
                  params=jax.tree.map(jnp.asarray, classifier_tree("swiglu_attn_bias")))
    return tr.train_step(classifier_batches()[0])["loss"]


def classifier_checkpoint(mesh, path):
    """A classifier drawn from seed 0, its encoder trained for one step at
    `mesh`, saved to `path` (rank 0 writes); the logits of the model as it
    stands, on the second batch."""
    from bioreason_tpu_torch import config as TC
    from bioreason_tpu_torch.models.classifier import classifier_forward
    from bioreason_tpu_torch.train.classifier import ClassifierTrainer
    cfg = TC.EncoderConfig.tiny()
    tr = ClassifierTrainer(cfg, CLASSES, optim=TC.OptimConfig(**OPTIM),
                           train_just_classifier=False, seed=0, device="cpu", mesh=mesh)
    b0, b1 = classifier_batches()
    tr.train_step(b0)
    tr.save(path, "tiny", ["a", "b", "c"])
    keys = ("ref_ids", "alt_ids", "ref_attention_mask", "alt_attention_mask")
    with torch.no_grad(), tr.run.scope():
        logits = classifier_forward(tr.model, cfg, *(t(b1[k]) for k in keys))
    return logits.numpy()


# -- fusion: SFT and the engine ------------------------------------------------------

def tok():
    from bioreason_tpu_torch.data import ByteTextTokenizer
    return ByteTextTokenizer()


def processor():
    from bioreason_tpu_torch.data import BioProcessor, KmerTokenizer
    return BioProcessor(tok(), KmerTokenizer())


def fusion_cfg(module, **enc):
    cfg = module.FusionConfig.tiny(text_vocab=tok().vocab_size,
                                   dna_pad_token_id=tok().dna_pad_id)
    return dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, **enc),
                               max_length_dna=64)


def fusion_tree():
    """The JAX fusion tree (numpy) at tiny widths, encoder biases drawn."""
    if "fusion" not in _TREES:
        import jax
        from bioreason_tpu import config as JC
        from bioreason_tpu.models.fusion import init_fusion
        tree = jax.jit(init_fusion, static_argnums=1)(jax.random.PRNGKey(0), fusion_cfg(JC))
        _TREES["fusion"] = _with_biases(jax.tree.map(np.asarray, tree), 3)
    return _TREES["fusion"]


def sft_setup(**enc):
    from bioreason_tpu_torch import config as TC
    from bioreason_tpu_torch.data import collate as TD
    from bioreason_tpu_torch.data import kegg as TK
    fcfg = fusion_cfg(TC, **enc)
    scfg = TC.SFTConfig(batch_size=4, max_length_dna=64, bucket=None, frozen_dtype="",
                        freeze_encoder=False, optim=TC.OptimConfig(**OPTIM),
                        lora=TC.LoRAConfig(r=4, alpha=8, dropout=0.0))
    exs = [TK.format_kegg_for_dna_llm(it) for it in TK.synthetic_kegg_items(4, seq_len=240,
                                                                            seed=10)]
    return fcfg, scfg, TD.sft_collate(exs, processor(), 512, 64, bucket=None)


def sft_trainer(mesh=None):
    from bioreason_tpu_torch.train.sft import SFTTrainer
    from bioreason_tpu_torch.weights import from_jax_params
    fcfg, scfg, batch = sft_setup(remat=True)
    tr = SFTTrainer(fcfg, scfg, model=from_jax_params(fusion_tree(), fcfg, device="cpu"),
                    device="cpu", mesh=mesh)
    return tr, batch


def sft_logits(tr, batch):
    """The trainer's model's fp32 logits on the batch (whole on every rank)."""
    from bioreason_tpu_torch.models.fusion import fusion_forward
    keys = ("input_ids", "attention_mask", "dna_input_ids", "dna_attention_mask")
    with torch.no_grad(), tr.inference_scope():
        logits, _ = fusion_forward(tr.model, tr.fusion_cfg, *(t(batch[k]) for k in keys))
    return logits.numpy()


def sft_encoder_grads(mesh=None, path=None):
    """One SFT loss and its encoder gradients (whole, summed over the ranks
    that computed parts of them) with the tower trained and recomputed in
    the backward; with `path`, then one step, saved there (rank 0 writes),
    and the logits after it."""
    tr, batch = sft_trainer(mesh)
    loss, grads = tr.loss_and_grads(tr._device_batch(batch))
    if mesh is not None:
        grads = [tr.run.plan.unshard(n, g) for n, g in zip(tr.names, tr.opt.reduce(grads))]
    out = (float(loss.detach()), {n: g.numpy() for n, g in zip(tr.names, grads)
                                  if n.startswith("encoder.")})
    if path is None:
        return out
    tr.train_step(batch)
    tr.save(path)
    return out + (sft_logits(tr, batch),)


@functools.lru_cache(maxsize=None)
def engine_inputs():
    from bioreason_tpu_torch.data import kegg as TK
    from bioreason_tpu_torch.data.chat_template import apply_chat_template
    unique = [TK.format_kegg_prompt_only(it)
              for it in TK.synthetic_kegg_items(4, seq_len=24, seed=0)]
    out = processor()([apply_chat_template(ex)["prompt"] for ex in unique],
                      [ex["dna_sequences"] for ex in unique], max_length_dna=64,
                      padding_side="left")
    return out.input_ids, out.attention_mask, out.dna_input_ids, out.dna_attention_mask


def engine_tokens(mesh):
    from bioreason_tpu_torch import config as TC
    from bioreason_tpu_torch.generate.engine import GenerationEngine
    from bioreason_tpu_torch.parallel.trainer import MeshRun
    from bioreason_tpu_torch.weights import from_jax_params
    cfg = fusion_cfg(TC)
    model = from_jax_params(fusion_tree(), cfg, device="cpu")
    run = MeshRun(mesh, model, cfg.decoder, encoder_cfg=cfg.encoder)
    ids, _ = GenerationEngine(cfg, tok().eos_token_id, device="cpu", run=run).generate(
        model, *engine_inputs(), greedy=True, max_new_tokens=NEW)
    return np.asarray(ids), getattr(model.encoder.layers[0].attn.q, "tp", (None,))[0]


@functools.lru_cache(maxsize=None)
def jax_engine_tokens():
    """The JAX engine's greedy tokens on the tree sharded over (1, 1, 2)."""
    import jax
    from bioreason_tpu import config as JC
    from bioreason_tpu.generate import GenerationEngine as JEngine
    from bioreason_tpu.parallel import make_mesh
    from bioreason_tpu.parallel.partition import partition_rules_fusion, shardings_for_params
    params = fusion_tree()
    mesh = make_mesh(JC.MeshConfig(1, 1, 2), devices=jax.devices()[:2])
    sharded = jax.device_put(params, shardings_for_params(params, partition_rules_fusion(),
                                                          mesh))
    ids, _ = JEngine(fusion_cfg(JC), eos_token_id=tok().eos_token_id).generate(
        sharded, *engine_inputs(), greedy=True, max_new_tokens=NEW)
    return np.asarray(ids)


def replicated_towers(mesh):
    """An `sp` NT tower and an Evo2 tower in SFTTrainer(mesh): the tp markers
    of every encoder linear and of the decoder's q, the encoder's q rows."""
    from bioreason_tpu_torch import config as TC
    from bioreason_tpu_torch.parallel.partition import encoder_local_heads
    from bioreason_tpu_torch.train.sft import SFTTrainer
    fcfg, scfg, _ = sft_setup(attention_impl="sp")
    out = {}
    for label, cfg in (("sp", fcfg), ("evo2", dataclasses.replace(
            fcfg, encoder_kind="evo2", hyena=TC.HyenaConfig.tiny()))):
        tr = SFTTrainer(cfg, dataclasses.replace(scfg, freeze_encoder=True), device="cpu",
                        mesh=mesh)
        enc = tr.model.encoder
        out[label] = {
            "enc_tp": sorted(n for n, m in enc.named_modules() if getattr(m, "tp", None)),
            "enc_model_placed": sorted(n for n, pl in tr.run.plan.placements.items()
                                       if n.startswith("encoder.") and
                                       any(ax == "model" for ax, _ in pl)),
            "enc_shapes_whole": all(tuple(p.shape) == tuple(q.shape) for p, q in zip(
                enc.parameters(), type(enc)(cfg.dna_tower, "cpu").parameters())),
            "dec_q_tp": getattr(tr.model.decoder.layers[0].attn.q, "tp", (None,))[0],
            "tower_tp": tr.run.plan.tower_tp,
            "heads": encoder_local_heads(cfg.encoder, tr.run)}
    return out


def tp_dense_biased(axis):
    """A colwise 8 -> 6 and a rowwise 6 -> 8 biased linear split over
    `axis`: each output (gathered for the colwise one) and its bias's
    gradient (summed over the axis for the colwise one, as `grad_axes`
    does), beside one device's F.linear."""
    from bioreason_tpu_torch.models import layers as L
    from bioreason_tpu_torch.parallel import comm
    gen = torch.Generator().manual_seed(7)
    out = {}
    for kind, (i, o) in (("col", (8, 6)), ("row", (6, 8))):
        w, b = torch.randn(o, i, generator=gen), torch.randn(o, generator=gen)
        x, g = torch.randn(3, 5, i, generator=gen), torch.randn(3, 5, o, generator=gen)
        ref = torch.nn.functional.linear(x, w, b)
        lin = torch.nn.Linear(i, o)
        dim = 0 if kind == "col" else 1
        lin.weight = torch.nn.Parameter(comm.local_slice(w, axis, dim).clone())
        lin.bias = torch.nn.Parameter(b.clone())
        lin.tp = (kind, axis)
        y = L.dense(lin, x if kind == "col" else comm.local_slice(x, axis, 2).contiguous())
        (y * (comm.local_slice(g, axis, 2) if kind == "col" else g)).sum().backward()
        if kind == "col":
            y, gb = comm.all_gather(y, axis, 2), comm.all_reduce(lin.bias.grad, axis)
        else:
            gb = lin.bias.grad
        out[kind] = {"y": y.detach().numpy(), "ref": ref.numpy(), "gb": gb.numpy(),
                     "ref_gb": g.reshape(-1, o).sum(0).numpy()}
    return out


# -- the worlds ------------------------------------------------------------------------

def _world(rank, world, mesh_shape, store_dir):
    import os
    import pickle

    from bioreason_tpu_torch.config import MeshConfig
    from bioreason_tpu_torch.parallel.mesh import make_mesh, topology
    with open(os.path.join(store_dir, "trees.pkl"), "rb") as f:
        _TREES.update(pickle.load(f))
    mesh = make_mesh(MeshConfig(*mesh_shape), device="cpu")
    out = {"encoder": {c: port_encoder_out(c, mesh) for c in ENC_CASES}}
    if mesh_shape == (1, 1, 2):
        out["tp_dense"] = tp_dense_biased(topology(mesh).model)
        out["classifier"] = {ft: classifier_steps(ft, mesh) for ft in (False, True)}
        out["checkpoint"] = classifier_checkpoint(mesh, os.path.join(store_dir, "cls"))
        out["sft"] = sft_encoder_grads(mesh, os.path.join(store_dir, "sft"))
        out["engine"] = engine_tokens(mesh)
        out["replicated"] = replicated_towers(mesh)
    return out


_WORLDS = {}


def world_results(mesh_shape, tmp_path_factory):
    if mesh_shape not in _WORLDS:
        tmp = tmp_path_factory.mktemp("tp_enc")
        for case in ENC_CASES:
            classifier_tree(case)
        fusion_tree()
        # through a file: a spawned process reads its arguments only once it
        # has started, so megabytes of them would start the ranks one by one
        with open(tmp / "trees.pkl", "wb") as f:
            pickle.dump(_TREES, f)
        _WORLDS[mesh_shape] = (spawn_world(_world, int(np.prod(mesh_shape)), tmp,
                                           mesh_shape, str(tmp)), tmp)
    return _WORLDS[mesh_shape]


@pytest.fixture(scope="module", params=MESHES, ids=lambda m: "x".join(map(str, m)))
def world(request, tmp_path_factory):
    return request.param, world_results(request.param, tmp_path_factory)[0]


@pytest.fixture(scope="module")
def world112(tmp_path_factory):
    return world_results((1, 1, 2), tmp_path_factory)


# -- encoder_forward ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def one_device_encoder(case):
    return port_encoder_out(case)


@pytest.mark.parametrize("case", ENC_CASES)
def test_encoder_forward_under_tp_matches_one_device(world, case):
    """Every rank's hidden states at 1e-5 of one device's; a rank holds
    num_heads / m heads (every head where they do not divide) and I / m MLP
    rows, colwise q / gate-or-up and rowwise o / down marked."""
    from bioreason_tpu_torch import config as TC
    mesh_shape, results = world
    m = mesh_shape[2]
    cfg = enc_cfg(TC, case)
    want = one_device_encoder(case)
    split_attn = cfg.num_heads % m == 0
    for res in results:
        got = res["encoder"][case]
        np.testing.assert_allclose(got["h"], want["h"], atol=1e-5, rtol=0)
        assert got["heads"] == (cfg.num_heads // m if split_attn else cfg.num_heads)
        assert got["q_rows"] == got["heads"] * cfg.head_dim
        assert got["mlp_rows"] == cfg.intermediate_size // m
        assert got["tp"] == {"q": "col" if split_attn else None,
                             "o": "row" if split_attn else None,
                             "in": "col", "down": "row"}


@pytest.mark.parametrize("case", ENC_CASES)
def test_encoder_forward_under_tp_matches_jax(world, case):
    """Every rank's hidden states at 1e-5 of the JAX encoder_forward on the
    same tree (the Pallas local kernel in interpret mode for `local:8`)."""
    _, results = world
    want = jax_encoder_out(case)
    for res in results:
        np.testing.assert_allclose(res["encoder"][case]["h"], want, atol=1e-5, rtol=0)


def _fake_topo(m):
    from bioreason_tpu_torch.parallel.comm import Axis
    from bioreason_tpu_torch.parallel.mesh import Topology
    one = lambda name: Axis(name, None, 1, 0, (0,))
    return Topology(one("data"), one("fsdp"), Axis("model", None, m, 0, tuple(range(m))),
                    one("dp"))


@pytest.mark.parametrize("case", ["swiglu_attn_bias", "gelu_mlp_bias", "heads_3", "sp"])
def test_classifier_placements_follow_the_jax_rules(case):
    """Per classifier parameter at model 2: a `model` placement exactly where
    the JAX classifier's `^encoder/` rules put 'model' (on the transposed dim
    of an nn.Linear weight), but in a block whose heads do not divide and
    under `sp`, which stay replicated; biases and everything outside the
    encoder's layers unplaced; the colwise biases partial over 'model'."""
    from bioreason_tpu import config as JC
    from bioreason_tpu.parallel import partition as JP
    from bioreason_tpu_torch import config as TC
    from bioreason_tpu_torch.models.classifier import init_classifier
    from bioreason_tpu_torch.parallel.partition import ShardPlan
    cfg = enc_cfg(TC, "swiglu_attn_bias" if case == "sp" else case)
    if case == "sp":
        cfg = dataclasses.replace(cfg, attention_impl="sp")
    model = init_classifier(cfg, CLASSES, 0, "cpu")
    plan = ShardPlan(model, None, _fake_topo(2), encoder_cfg=cfg)
    rules = [(r"^encoder/" + pat, spec) for pat, spec in JP.partition_rules_encoder()]
    jcfg = enc_cfg(JC, "swiglu_attn_bias" if case == "sp" else case)
    n_model = 0
    for name, p in model.named_parameters():
        path, transposed, layer = _jax_path(name)
        want = list(JP.spec_for_path(path, rules)) + [None] * 3
        want = want[1:p.dim() + 1] if layer else want[:p.dim()]
        if transposed:
            want = want[::-1]
        dims = [d for ax, d in plan.placements[name] if ax == "model"]
        replicated = case == "sp" or (".attn." in name and jcfg.num_heads % 2)
        assert dims == ([] if replicated or "model" not in want else [want.index("model")]), name
        n_model += bool(dims)
        colwise_bias = (name.endswith(".bias") and
                        ("model", 0) in plan.placements.get(name[:-4] + "weight", []))
        assert (name in plan.partial_over_model) == colwise_bias, name
    assert n_model == {"swiglu_attn_bias": 14, "gelu_mlp_bias": 12, "heads_3": 6, "sp": 0}[case]
    assert plan.tower_tp == (case != "sp")


@pytest.mark.parametrize("kind", ["col", "row"])
def test_tp_dense_takes_biased_linears(world112, kind):
    """`layers.tp_dense` on a biased float linear split over two ranks: the
    output equals one device's F.linear (colwise: each rank's slice of the
    rows; rowwise: the bias added once after the sum) and the bias's
    gradient equals one device's (colwise: the ranks' slices summed)."""
    results, _ = world112
    for res in results:
        got = res["tp_dense"][kind]
        np.testing.assert_allclose(got["y"], got["ref"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(got["gb"], got["ref_gb"], atol=1e-5, rtol=0)


# -- the classifier -------------------------------------------------------------------------

@pytest.mark.parametrize("finetune", [False, True])
def test_classifier_steps_under_tp_match_one_device(world112, finetune):
    """Two steps at (1, 1, 2), the encoder frozen or trained: loss and grad
    norm at 1e-5 relative, accuracy equal, every trained parameter (the
    encoder's gathered from its shards) at 1e-5 of one device's."""
    results, _ = world112
    want_m, want_s = classifier_steps(finetune)
    assert any(n.startswith("encoder.") for n in want_s) == finetune
    for res in results:
        got_m, got_s = res["classifier"][finetune]
        for g, w in zip(got_m, want_m):
            assert g["loss"] == pytest.approx(w["loss"], rel=1e-5)
            assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=1e-5)
            assert g["accuracy"] == w["accuracy"]
        assert set(got_s) == set(want_s)
        for k in want_s:
            np.testing.assert_allclose(got_s[k], want_s[k], atol=1e-5, rtol=0, err_msg=k)


@pytest.mark.parametrize("finetune", [False, True])
def test_classifier_first_loss_matches_jax_on_a_model_mesh(world112, finetune):
    """The first loss at (1, 1, 2) against the JAX ClassifierTrainer's on a
    (1, 1, 2) JAX CPU mesh, from the same tree (1e-5)."""
    results, _ = world112
    want = jax_classifier_first_loss()
    for res in results:
        assert res["classifier"][finetune][0][0]["loss"] == pytest.approx(want, abs=1e-5)


def test_classifier_checkpoint_at_model_2_loads_on_one_device(world112):
    """`ClassifierTrainer.save` at (1, 1, 2) (the encoder trained, its shards
    gathered, rank 0 writing) read back by `load_classifier` on one device:
    the same logits as the tensor-parallel model (1e-5)."""
    from bioreason_tpu_torch import config as TC
    from bioreason_tpu_torch.models.classifier import classifier_forward
    from bioreason_tpu_torch.train.checkpoint import load_classifier
    results, tmp = world112
    cfg = TC.EncoderConfig.tiny()
    model, labels = load_classifier(str(tmp / "cls"), cfg, "tiny", device="cpu")
    assert labels == ["a", "b", "c"]
    b1 = classifier_batches()[1]
    keys = ("ref_ids", "alt_ids", "ref_attention_mask", "alt_attention_mask")
    with torch.no_grad():
        got = classifier_forward(model, cfg, *(t(b1[k]) for k in keys)).numpy()
    for res in results:
        np.testing.assert_allclose(got, res["checkpoint"], atol=1e-5, rtol=0)


# -- SFT, the engine, the towers left replicated ------------------------------------------------

def test_sft_finetune_encoder_grads_under_tp_match_one_device(world112):
    """One SFT loss with the tower trained (remat on) at (1, 1, 2): the loss
    at 1e-5 relative and every encoder gradient at 1e-5 of one device's,
    the colwise biases' (each rank's slice, summed over 'model') and the
    rowwise ones' (added once) among them."""
    results, _ = world112
    want_loss, want = sft_encoder_grads()
    assert any(re.search(r"attn\.q\.bias$", n) for n in want)
    assert any(re.search(r"attn\.o\.bias$", n) for n in want)
    for res in results:
        loss, got, _ = res["sft"]
        assert loss == pytest.approx(want_loss, rel=1e-5)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0, err_msg=k)


def test_sft_checkpoint_at_model_2_restores_on_one_device(world112):
    """`SFTTrainer.save` at (1, 1, 2) after a step with the tower trained
    (the encoder's shards and their moments gathered, rank 0 writing),
    restored by a one-device trainer: its encoder holds whole tensors and
    its logits equal the tensor-parallel model's (1e-5)."""
    results, tmp = world112
    tr, batch = sft_trainer()
    tr.restore(str(tmp / "sft"))
    assert tr.step == 1
    assert tuple(tr.model.encoder.layers[0].attn.q.weight.shape) == (64, 64)
    got = sft_logits(tr, batch)
    for res in results:
        np.testing.assert_allclose(got, res["sft"][2], atol=1e-5, rtol=0)


def test_engine_greedy_tokens_with_tp_tower_match_jax(world112):
    """The engine on a run whose decoder and NT tower are both split over
    'model' (1, 1, 2): greedy tokens equal the JAX engine's on the tree
    sharded over the same mesh."""
    results, _ = world112
    want = jax_engine_tokens()
    for res in results:
        ids, q_tp = res["engine"]
        assert q_tp == "col"
        np.testing.assert_array_equal(ids, want)


@pytest.mark.parametrize("tower", ["sp", "evo2"])
def test_sp_and_evo2_towers_stay_replicated(world112, tower):
    """SFTTrainer(mesh=) at (1, 1, 2) with an `sp` NT tower (sequence
    parallelism takes 'model') or an Evo2 tower (no JAX rule names its
    parameters): no tower linear carries a `tp` marker, no tower parameter
    is placed over 'model' or sliced; the decoder still is."""
    results, _ = world112
    for res in results:
        got = res["replicated"][tower]
        assert got["enc_tp"] == [] and got["enc_model_placed"] == []
        assert got["enc_shapes_whole"] and not got["tower_tp"]
        assert got["dec_q_tp"] == "col"
        assert got["heads"] == 4


# -- the CLI -----------------------------------------------------------------------------------

def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_train_dna_only_cli_mesh_1_1_2(tmp_path):
    """`train_dna_only --cpu_devices 2 --mesh 1,1,2 --finetune_encoder` (refused
    before): one step and the test pass on two tensor-parallel ranks; the
    logged train and test metrics at 1e-5 of the one-device CLI's, and its
    dna_only_final (rank 0's write) holds the same parameters (1e-5)."""
    from bioreason_tpu_torch.cli import train_dna_only
    argv = ["--encoder", "tiny", "--device", "cpu", "--batch_size", "4", "--max_length_dna",
            "64", "--max_steps", "1", "--n_synthetic", "16", "--finetune_encoder",
            "--learning_rate", "1e-2"]
    train_dna_only.main(argv + ["--cpu_devices", "2", "--mesh", "1,1,2", "--checkpoint_dir",
                                str(tmp_path / "m"), "--log_dir", str(tmp_path / "ml")])
    train_dna_only.main(argv + ["--checkpoint_dir", str(tmp_path / "o"), "--log_dir",
                                str(tmp_path / "ol")])
    got, want = _rows(tmp_path / "ml" / "metrics.jsonl"), _rows(tmp_path / "ol" / "metrics.jsonl")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        keys = sorted(k for k in w if k not in ("time",))
        assert sorted(k for k in g if k != "time") == keys
        for k in keys:
            assert g[k] == pytest.approx(w[k], rel=1e-5, abs=1e-7), k
    a = torch.load(tmp_path / "m" / "dna_only_final" / "state.pt")
    b = torch.load(tmp_path / "o" / "dna_only_final" / "state.pt")
    assert set(a["trainable"]) == set(b["trainable"])
    assert any(k.startswith("encoder.layers.") for k in b["trainable"])
    for k in b["trainable"]:
        np.testing.assert_allclose(a["trainable"][k], b["trainable"][k], atol=1e-5, err_msg=k)
