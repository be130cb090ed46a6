"""GPipe over the decoder's layers (bioreason_tpu_torch/parallel/pp.py) in
worlds of 2 and 4 gloo ranks on the CPU, fp32, held against the plain
`decoder_forward` (JAX's own pp test was red at the seed, so not against
JAX pp.py): the last hidden state (1e-5) and every parameter's gradient
(1e-5) for several n_micro; JAX's ValueErrors; and the PP trainer's loss
against the tensor-parallel trainer's on the same mesh at rtol 2e-3 (JAX
tests/test_pp.py:124-131), plus PP with data parallelism against one
device. Each world is spawned once (module fixtures)."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from test_torch_mesh import spawn_world

torch.set_num_threads(1)

CASES = {2: [(2, 1), (2, 2), (2, 4)], 4: [(4, 4), (4, 2)]}   # world: (layers, n_micro)


def decoder_case(num_layers):
    from bioreason_tpu_torch import config as TC
    from bioreason_tpu_torch.models.layers import init_normal_
    from bioreason_tpu_torch.models.qwen3 import Qwen3Decoder
    from bioreason_tpu_torch.train.lora import attach_lora
    cfg = dataclasses.replace(TC.DecoderConfig.tiny(), num_layers=num_layers, head_dim=64,
                              remat=False)
    dec = init_normal_(Qwen3Decoder(cfg), torch.Generator().manual_seed(0))
    attach_lora(dec, TC.LoRAConfig(r=4, alpha=8), torch.Generator().manual_seed(1))
    with torch.no_grad():                     # nonzero B: the adapters' path counts
        for n, p in dec.named_parameters():
            if n.endswith("lora_b"):
                p.normal_(0, 0.05, generator=torch.Generator().manual_seed(len(n)))
    rng = np.random.default_rng(num_layers)
    ids = torch.tensor(rng.integers(3, cfg.vocab_size, (4, 12)))
    mask = torch.ones(4, 12, dtype=torch.int64)
    mask[1, :3] = 0
    w = torch.tensor(rng.standard_normal((4, 12, cfg.hidden_size)).astype(np.float32))
    return cfg, dec, ids, mask, w


def decoder_grads(num_layers, axis=None, n_micro=1):
    """(last hidden state, {name: gradient}) of sum(h * w), plain or
    pipelined over `axis` (every rank holds every layer; it runs its
    stage's); a gradient is summed over the stages (each holds its part)."""
    from bioreason_tpu_torch.models.qwen3 import decoder_forward
    from bioreason_tpu_torch.parallel import comm
    from bioreason_tpu_torch.parallel.pp import pipeline_sharding
    cfg, dec, ids, mask, w = decoder_case(num_layers)
    scope = pipeline_sharding(None)
    if axis is not None:
        s = num_layers // axis.size
        scope = pipeline_sharding(axis, n_micro, layers=range(axis.index * s,
                                                               (axis.index + 1) * s))
    with scope:
        h, _ = decoder_forward(dec, cfg, ids, attention_mask=mask, return_hidden=True)
    loss = (h * w).sum()
    last = axis is None or axis.index == axis.size - 1
    named = dict(dec.named_parameters())
    grads = torch.autograd.grad(loss if last else loss * 0.0, list(named.values()),
                                allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(named.values(), grads)]
    if axis is not None:
        grads = [comm.all_reduce(g, axis) for g in grads]
    return h.detach().numpy(), {n: g.numpy() for n, g in zip(named, grads)}


def _errors(axis):
    from bioreason_tpu_torch.models.qwen3 import decoder_forward
    from bioreason_tpu_torch.parallel.pp import pipeline_sharding
    out = []
    for layers, n_micro in ((3, 1), (2, 3)):
        cfg, dec, ids, mask, _ = decoder_case(layers)
        try:
            with pipeline_sharding(axis, n_micro, layers=range(axis.index, axis.index + 1)):
                decoder_forward(dec, cfg, ids, attention_mask=mask)
        except ValueError as e:
            out.append(str(e))
    return out


def sft_losses(mesh=None, pp_micro=0):
    from test_torch_parallel_train import sft_setup
    from bioreason_tpu_torch.train.sft import SFTTrainer
    fcfg, scfg, batches = sft_setup()
    tr = SFTTrainer(fcfg, dataclasses.replace(scfg, pp_micro=pp_micro), device="cpu", mesh=mesh)
    metrics = [tr.train_step(b) for b in batches]
    return metrics, {k: v.detach().numpy() for k, v in tr.trainable_state().items()}


def _pp_world(rank, world):
    from bioreason_tpu_torch.config import MeshConfig
    from bioreason_tpu_torch.parallel.mesh import make_mesh, topology
    mesh = make_mesh(MeshConfig(data=1, fsdp=1, model=world), device="cpu")
    axis = topology(mesh).model
    out = {"ops": {c: decoder_grads(c[0], axis, c[1]) for c in CASES[world]}}
    if world == 2:
        out["errors"] = _errors(axis)
        out["pp"] = sft_losses(mesh, pp_micro=2)
        out["tp"] = sft_losses(mesh)
    else:
        out["pp_dp"] = sft_losses(make_mesh(MeshConfig(2, 1, 2), device="cpu"), pp_micro=2)
    return out


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return spawn_world(_pp_world, 2, tmp_path_factory.mktemp("pp2"))


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return spawn_world(_pp_world, 4, tmp_path_factory.mktemp("pp4"))


@functools.lru_cache(maxsize=None)
def plain(num_layers):
    return decoder_grads(num_layers)


@pytest.mark.parametrize("world,case", [(w, c) for w in CASES for c in CASES[w]])
def test_pipeline_matches_plain_decoder(request, world, case):
    """Every rank's last hidden state (the last stage's, broadcast) and the
    gradients of every parameter (layers from their stage, the embedding
    from the first, the final norm from the last) against the plain
    decoder_forward, 1e-5 (gradients: 1e-5 of each parameter's largest
    |gradient|; the embedding's rows sum the microbatches in another
    order)."""
    want_h, want_g = plain(case[0])
    for res in request.getfixturevalue(f"world{world}"):
        h, grads = res["ops"][case]
        np.testing.assert_allclose(h, want_h, atol=1e-5, rtol=1e-5)
        for name in want_g:
            scale = max(1.0, float(np.abs(want_g[name]).max()))
            np.testing.assert_allclose(grads[name], want_g[name], atol=1e-5 * scale,
                                       rtol=1e-5, err_msg=name)


def test_pipeline_value_errors_as_jax(world2):
    """JAX pp.py's two ValueErrors: layers that do not split into the
    stages, a batch that does not split into the microbatches."""
    assert world2[0]["errors"] == ["num_layers 3 not divisible by 2 stages",
                                   "batch 4 not divisible by dp 1 x n_micro 3"]


def test_pp_trainer_loss_matches_tp_trainer(world2):
    """Two SFT steps at mesh (1, 1, 2): pp_micro=2 (GPipe) against 0
    (tensor parallelism), losses at rtol 2e-3 as JAX's test; and both
    against the one-device trainer's parameters (1e-5)."""
    from test_torch_parallel_train import one_device
    for res in world2:
        pm, ps = res["pp"]
        tm, _ = res["tp"]
        for a, b in zip(pm, tm):
            assert a["loss"] == pytest.approx(b["loss"], rel=2e-3)
        want_m, want_s, _ = one_device()
        for a, b in zip(pm, want_m):
            assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)
            assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=1e-5)
        assert set(ps) == set(want_s)
        for k in want_s:
            np.testing.assert_allclose(ps[k], want_s[k], atol=1e-5, rtol=0, err_msg=k)


def test_pp_with_data_parallelism_matches_one_device(world4):
    """GPipe over 'model' with the batch split over 'data' (2, 1, 2)."""
    from test_torch_parallel_train import one_device
    want_m, want_s, _ = one_device()
    for res in world4:
        pm, ps = res["pp_dp"]
        for a, b in zip(pm, want_m):
            assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)
            assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=1e-5)
        for k in want_s:
            np.testing.assert_allclose(ps[k], want_s[k], atol=1e-5, rtol=0, err_msg=k)
