"""The port's Qwen3-MoE serving path against the JAX package.

Tiny MoE configs (`tiny_moe`: E=4, k=2) in fp32 on the CPU. Weights are drawn
once by the JAX package and carried over by `from_jax_params`; inputs come
from a numpy seed. The JAX references run through `jax.jit` and are cached.
The capacity C = max(k, ceil(cf * k * N / E)) counts every row of a call, so
the default factor 1.25 binds in these calls: left pads, empty batcher rows
and the completions of a group take part, and the port must drop the same
tokens as JAX."""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from bioreason_tpu import config as JC
from bioreason_tpu.data.nt_tokenizer import KmerTokenizer as JKmer
from bioreason_tpu.data.processor import BioProcessor as JProc
from bioreason_tpu.data.text_tokenizer import ByteTextTokenizer as JByte
from bioreason_tpu.generate import continuous as JCB
from bioreason_tpu.generate.engine import GenerationEngine as JEngine
from bioreason_tpu.models import layers as JL
from bioreason_tpu.models.fusion import init_fusion as j_init
from bioreason_tpu.models.qwen3 import decoder_forward as j_decoder_forward
from bioreason_tpu.train import fuse as JF
from bioreason_tpu.train import quant as JQ
from bioreason_tpu.utils import pretrained as JP
from bioreason_tpu_torch import config as TC
from bioreason_tpu_torch.generate.continuous import ContinuousBatcher, Request
from bioreason_tpu_torch.generate.engine import GenerationEngine as TEngine
from bioreason_tpu_torch.models import layers as TL
from bioreason_tpu_torch.models.fusion import init_fusion as t_init
from bioreason_tpu_torch.models.qwen3 import decoder_forward as t_decoder_forward
from bioreason_tpu_torch.serve import serving_storage
from bioreason_tpu_torch.train import quant as TQ
from bioreason_tpu_torch.utils import pretrained as TP
from bioreason_tpu_torch.utils.safetensors_io import save_file
from bioreason_tpu_torch.weights import from_jax_params

# one intra-op thread: the tensors here are tiny, and pytest-xdist runs
# several workers on the host's cores, which torch's default of a thread
# per core oversubscribes many times over
torch.set_num_threads(1)

TOK = JByte()
PROC = JProc(TOK, JKmer())
NEW = 8
PROMPTS = ["what pathway does this variant disrupt?", "short", "a dna question here"]


@pytest.fixture(autouse=True)
def no_grad():
    with torch.no_grad():
        yield


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def moe_cfgs(w8a8=False):
    """(JAX, port) fusion configs: the tiny towers with the tiny MoE decoder."""
    out = []
    for C in (JC, TC):
        cfg = C.FusionConfig.tiny(text_vocab=TOK.vocab_size, dna_pad_token_id=TOK.dna_pad_id)
        dec = dataclasses.replace(C.DecoderConfig.tiny_moe(TOK.vocab_size), act_int8=w8a8)
        out.append(dataclasses.replace(cfg, decoder=dec, encoder=dataclasses.replace(
            cfg.encoder, act_int8=w8a8)))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def tree():
    jcfg, _ = moe_cfgs()
    return np_tree(jax.jit(j_init, static_argnums=1)(jax.random.PRNGKey(0), jcfg))


@functools.lru_cache(maxsize=None)
def served_tree(mode):
    """The JAX tree of a serving flag set, quantized then fused as the JAX
    server does."""
    t = tree()
    if mode != "plain":
        t = JQ.quantize_frozen_int8(t, include_embed=True)
        t = np_tree(JF.fuse_projections(t))
    return t


def port_model(mode="plain", w8a8=False):
    return from_jax_params(served_tree(mode), moe_cfgs(w8a8)[1], device="cpu")


def prompt_batch():
    out = PROC(text=PROMPTS, batch_dna_sequences=[["ACGTACGTAC"], ["GGCATTACA"], ["TTAGC"]],
               max_length_text=64, max_length_dna=16, padding_side="left")
    return out.input_ids, out.attention_mask, out.dna_input_ids, out.dna_attention_mask


class DropCounter:
    """Counts the (token, choice) pairs `moe_apply` drops, by wrapping
    `layers.moe_slots`."""

    def __init__(self, monkeypatch):
        self.kept = self.dropped = 0
        real = TL.moe_slots

        def counting(idx, e, cap):
            slot, keep = real(idx, e, cap)
            self.kept += int(keep.sum())
            self.dropped += int((~keep).sum())
            return slot, keep
        monkeypatch.setattr(TL, "moe_slots", counting)


# -- moe_apply ------------------------------------------------------------------

def moe_pair(seed, d=16, e=4, inter=32):
    """JAX moe params (fp32 numpy) and the port's MoE holding the same."""
    p = np_tree(JL.moe_init(jax.random.PRNGKey(seed), d, e, inter))
    m = TL.MoE(d, e, inter).requires_grad_(False)
    with torch.no_grad():
        m.router.weight.copy_(torch.tensor(p["router"]["kernel"].T))
        for n in ("gate", "up", "down"):
            getattr(m.experts, n).weight.copy_(torch.tensor(p["experts"][n]))
    return p, m


@functools.lru_cache(maxsize=None)
def j_moe(k, norm, cf, dtype="float32"):
    return jax.jit(lambda p, x: JL.moe_apply(p, x, k, norm, jnp.dtype(dtype), cf))


@pytest.mark.parametrize("norm", [True, False])
@pytest.mark.parametrize("cf", [2.0, 1.25])
def test_moe_apply_matches_jax(cf, norm):
    """Lossless capacity (cf = E / k) and the default 1.25, which drops
    here; norm_topk_prob on and off; fp32 at 1e-5."""
    p, m = moe_pair(0)
    x = np.random.default_rng(0).standard_normal((3, 10, 16)).astype(np.float32)
    want = np.asarray(j_moe(2, norm, cf)(p, x))
    got = TL.moe_apply(m, torch.tensor(x), 2, norm, torch.float32, cf)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=0)


def test_capacity_drops_with_left_pads_and_identical_tokens():
    """JAX's `test_capacity_drops_tokens` case with left pads: every row
    routes the same way, the pads come first in (b, t) order and fill
    their expert's capacity before the real tokens behind them; the
    dropped rows are zero in both packages and the kept ones agree."""
    p, m = moe_pair(2, d=8, e=4, inter=16)
    rng = np.random.default_rng(3)
    pad, tok = rng.standard_normal(8).astype(np.float32), rng.standard_normal(8).astype(np.float32)
    x = np.broadcast_to(tok, (2, 16, 8)).copy()
    x[:, :6] = pad                                  # six left pads per row
    want = np.asarray(j_moe(1, True, 0.25)(p, x))
    got = TL.moe_apply(m, torch.tensor(x), 1, True, torch.float32, 0.25).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    dropped = np.abs(want).sum(-1) == 0
    assert ((np.abs(got).sum(-1) == 0) == dropped).all()
    assert dropped.any() and not dropped.all()
    assert not dropped[0, 0] and dropped[1, 0]      # the second row's pads are past C


def test_bf16_ties_route_to_the_lower_expert_as_jax():
    """A router whose columns repeat ties exactly in bf16: the port's
    stable sort picks the experts `jax.lax.top_k` picks (lower index
    first), and the bf16 outputs agree; `torch.topk` picks others."""
    p, m = moe_pair(4, d=16, e=8, inter=16)
    kern = p["router"]["kernel"].copy()
    kern[:, 4:] = kern[:, :4]                        # experts j and j + 4 tie
    p = {**p, "router": {"kernel": kern}}
    with torch.no_grad():
        m.router.weight.copy_(torch.tensor(kern.T))
    x = np.random.default_rng(5).standard_normal((2, 32, 16)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16).reshape(-1, 16)
    probs = jax.nn.softmax(JL.dense(p["router"], xb, jnp.bfloat16).astype(jnp.float32), -1)
    _, want_idx = jax.lax.top_k(probs, 3)
    _, idx = TL.moe_route(m, torch.tensor(x).to(torch.bfloat16).reshape(-1, 16), 3, True,
                          torch.bfloat16)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    want = np.asarray(j_moe(3, True, 4.0, "bfloat16")(p, x).astype(jnp.float32))
    got = TL.moe_apply(m, torch.tensor(x), 3, True, torch.bfloat16, 4.0).float().numpy()
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


class MaxNumel(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.max = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in jax.tree.leaves(out):
            if isinstance(t, torch.Tensor):
                self.max = max(self.max, t.numel())
        return out


def test_index_form_allocates_nothing_of_n_e_c():
    """No tensor of moe_apply reaches N * E * C elements (the one-hot
    dispatch JAX builds); here the largest is the [E, C, H] buffer."""
    p, m = moe_pair(6, d=64, e=4, inter=64)
    x = torch.randn(4, 64, 64, generator=torch.Generator().manual_seed(0))
    n, e, cap = 256, 4, TL.moe_capacity(256, 4, 2, 1.25)
    with MaxNumel() as mode:
        TL.moe_apply(m, x, 2, True, torch.float32, 1.25)
    assert mode.max <= e * cap * 64 < n * e * cap // 2, (mode.max, n * e * cap)


def test_init_draws_the_jax_distributions():
    """Router N(0, 1/H) as a dense, gate and up N(0, 1/H), down N(0, 1/I)."""
    dec = dataclasses.replace(TC.DecoderConfig.tiny_moe(), hidden_size=256, num_experts=8,
                              moe_intermediate_size=128, num_layers=1)
    cfg = dataclasses.replace(TC.FusionConfig.tiny(), decoder=dec)
    moe = t_init(cfg, seed=0, device="cpu").decoder.layers[0].mlp
    for w, std in ((moe.router.weight, 256 ** -0.5), (moe.experts.gate.weight, 256 ** -0.5),
                   (moe.experts.up.weight, 256 ** -0.5), (moe.experts.down.weight, 128 ** -0.5)):
        assert abs(float(w.mean())) < 0.05 * std
        assert abs(float(w.std()) / std - 1) < 0.03, (tuple(w.shape), float(w.std()), std)
    assert tuple(moe.experts.down.weight.shape) == (8, 128, 256)


# -- int8 banks -------------------------------------------------------------------

def test_int8_banks_and_router_equal_jax_bit_for_bit():
    """The port's `quantize_frozen_int8` on the float model gives the JAX
    walk's int8 values and scales: banks [E, in, out] with [E, 1, out]
    scales, and the router, which the JAX walk quantizes as a `kernel`."""
    _, tcfg = moe_cfgs()
    model = TQ.quantize_frozen_int8(from_jax_params(tree(), tcfg, device="cpu"),
                                    include_embed=True)
    jq = JQ.quantize_frozen_int8(tree(), include_embed=True)["decoder"]["layers"]["mlp"]
    for i, layer in enumerate(model.decoder.layers):
        moe = layer.mlp
        np.testing.assert_array_equal(moe.router.weight.numpy(),
                                      np.asarray(jq["router"]["kernel"]["q"][i]).T)
        np.testing.assert_array_equal(moe.router.scale.numpy(),
                                      np.asarray(jq["router"]["kernel"]["scale"][i]).T)
        for n in ("gate", "up", "down"):
            bank = getattr(moe.experts, n)
            assert bank.weight.dtype == torch.int8 and bank.scale.shape[1] == 1
            np.testing.assert_array_equal(bank.weight.numpy(),
                                          np.asarray(jq["experts"][n]["q"][i]))
            np.testing.assert_array_equal(bank.scale.numpy(),
                                          np.asarray(jq["experts"][n]["scale"][i]))


def test_int8_moe_apply_matches_jax():
    p, m = moe_pair(7)
    jq = np_tree(JQ.quantize_frozen_int8({"decoder": {"mlp": p}})["decoder"]["mlp"])
    TQ.quantize_frozen_int8(torch.nn.ModuleDict({"decoder": m}))
    x = np.random.default_rng(8).standard_normal((2, 12, 16)).astype(np.float32)
    want = np.asarray(j_moe(2, True, 1.25)(jq, x))
    got = TL.moe_apply(m, torch.tensor(x), 2, True, torch.float32, 1.25).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# -- the decoder, the engine and the batcher ---------------------------------------

@pytest.mark.parametrize("mode", ["plain", "int8"])
def test_decoder_forward_logits_match_jax(mode):
    """Left-padded rows, drops included (the default capacity factor)."""
    jcfg, tcfg = moe_cfgs()
    jt = served_tree(mode)["decoder"]
    ids = np.random.default_rng(9).integers(3, 250, (3, 14)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[0, :5] = mask[2, :9] = 0
    want = jax.jit(lambda p, i, a: j_decoder_forward(p, jcfg.decoder, input_ids=i,
                                                     attention_mask=a)[0])(jt, ids, mask)
    got, _ = t_decoder_forward(port_model(mode).decoder, tcfg.decoder,
                               input_ids=torch.tensor(ids).long(),
                               attention_mask=torch.tensor(mask))
    np.testing.assert_allclose(got.numpy()[mask.astype(bool)],
                               np.asarray(want)[mask.astype(bool)], atol=2e-5, rtol=0)


@functools.lru_cache(maxsize=None)
def jax_tokens(mode, group):
    jcfg, _ = moe_cfgs(w8a8=mode == "w8a8")
    ids, _ = JEngine(jcfg, eos_token_id=-1).generate(
        served_tree("plain" if mode == "plain" else "int8"), *prompt_batch(), greedy=True,
        max_new_tokens=NEW, group_size=group)
    return ids


@pytest.mark.parametrize("mode,group", [("plain", 1), ("plain", 2), ("w8a8", 1)])
def test_engine_greedy_tokens_match_jax(mode, group, monkeypatch):
    """Ungrouped, at group_size=2 (the capacity counts every completion of
    the group) and under `--int8 --fuse --w8a8` (the MoE MLP stays unfused
    and weight-only, as in JAX); tokens are dropped on the way."""
    _, tcfg = moe_cfgs(w8a8=mode == "w8a8")
    model = port_model("plain" if mode == "plain" else "int8", w8a8=mode == "w8a8")
    if mode == "w8a8":
        assert hasattr(model.decoder.layers[0].attn, "qkv")
        assert not hasattr(model.decoder.layers[0].mlp, "gateup")
    drops = DropCounter(monkeypatch)
    ids, _ = TEngine(tcfg, eos_token_id=-1, device="cpu").generate(
        model, *prompt_batch(), greedy=True, max_new_tokens=NEW, group_size=group)
    np.testing.assert_array_equal(ids, jax_tokens(mode, group))
    assert drops.dropped > 0
    if group > 1:
        assert (ids[0::2] == ids[1::2]).all()


def test_serving_storage_on_a_moe_equals_the_jax_tree():
    """`serve --int8 --fuse` storage on the port's float MoE model equals
    the JAX server's quantized and fused tree carried over."""
    _, tcfg = moe_cfgs()
    mine = serving_storage(from_jax_params(tree(), tcfg, device="cpu"), int8=True, fuse=True)
    ref = port_model("int8").state_dict()
    got = mine.state_dict()
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        assert torch.equal(got[k], v), k


def batcher_requests(cls):
    texts = PROMPTS + ["another prompt of medium length", "x" * 40]
    quotas = [7, 3, 9, 5, 4]
    out = []
    for i, (t, q) in enumerate(zip(texts, quotas)):
        dna = [["ACGTACGTACGT"]] if i == 2 else None
        a = PROC(text=[t], batch_dna_sequences=dna, max_length_text=128, max_length_dna=32)
        out.append(cls(i, a.input_ids, a.attention_mask, a.dna_input_ids,
                       a.dna_attention_mask, max_new_tokens=q, greedy=True))
    return out


@functools.lru_cache(maxsize=None)
def jax_batcher_tokens():
    jcfg, _ = moe_cfgs()
    reqs = batcher_requests(JCB.Request)
    cb = JCB.ContinuousBatcher(tree(), jcfg, eos_token_id=-1, capacity=2, max_len=128,
                               max_new=16, prompt_bucket=64)
    assert len(cb.run(reqs, window=3)) == len(reqs)
    return [r.tokens for r in reqs]


def test_continuous_batcher_streams_under_churn_match_jax(monkeypatch):
    """Five requests with staggered quotas over two slots, windows of 3:
    the capacity of each decode window counts its `cb` rows, empty ones
    included, and each prefill its padded rows; the streams equal the JAX
    batcher's."""
    _, tcfg = moe_cfgs()
    drops = DropCounter(monkeypatch)
    reqs = batcher_requests(Request)
    cb = ContinuousBatcher(port_model(), tcfg, -1, device="cpu", capacity=2, max_len=128,
                           max_new=16, prompt_bucket=64)
    assert len(cb.run(reqs, window=3)) == len(reqs)
    assert [r.tokens for r in reqs] == jax_batcher_tokens()
    assert drops.dropped > 0


# -- the HF import and the refusals --------------------------------------------------

def write_moe_dir(path, mixed=False, vocab=96):
    """A tiny Qwen3-MoE directory as `save_pretrained` leaves it, from a
    numpy seed: config.json and one fp32 safetensors file (beside a
    tokenizer of up to `vocab` ids, where the caller writes one)."""
    h, e, inter, nl, hq, hkv, d, v = 32, 4, 24, 2, 4, 2, 8, vocab
    cfg = {"architectures": ["Qwen3MoeForCausalLM"], "model_type": "qwen3_moe",
           "vocab_size": v, "hidden_size": h, "intermediate_size": 48,
           "moe_intermediate_size": inter, "num_experts": e, "num_experts_per_tok": 2,
           "norm_topk_prob": False, "num_hidden_layers": nl, "num_attention_heads": hq,
           "num_key_value_heads": hkv, "head_dim": d, "rope_theta": 10000.0,
           "rms_norm_eps": 1e-6, "tie_word_embeddings": False, "decoder_sparse_step": 1,
           "mlp_only_layers": [1] if mixed else []}
    rng = np.random.default_rng(11)

    def r(*shape):
        return torch.tensor(rng.standard_normal(shape).astype(np.float32) * 0.2)
    state = {"model.embed_tokens.weight": r(v, h), "model.norm.weight": 1 + r(h),
             "lm_head.weight": r(v, h)}
    for i in range(nl):
        pre = f"model.layers.{i}."
        state.update({pre + "self_attn.q_proj.weight": r(hq * d, h),
                      pre + "self_attn.k_proj.weight": r(hkv * d, h),
                      pre + "self_attn.v_proj.weight": r(hkv * d, h),
                      pre + "self_attn.o_proj.weight": r(h, hq * d),
                      pre + "self_attn.q_norm.weight": 1 + r(d),
                      pre + "self_attn.k_norm.weight": 1 + r(d),
                      pre + "input_layernorm.weight": 1 + r(h),
                      pre + "post_attention_layernorm.weight": 1 + r(h),
                      pre + "mlp.gate.weight": r(e, h)})
        for j in range(e):
            state.update({pre + f"mlp.experts.{j}.gate_proj.weight": r(inter, h),
                          pre + f"mlp.experts.{j}.up_proj.weight": r(inter, h),
                          pre + f"mlp.experts.{j}.down_proj.weight": r(h, inter)})
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(cfg))
    save_file(state, str(path / "model.safetensors"))
    return str(path)


def test_hf_moe_import_matches_jax(tmp_path):
    """`decoder_config_from_hf` and `import_qwen3` on a Qwen3-MoE directory
    equal JAX's config and tree (bitwise, through `from_jax_params`' layout),
    the logits agree, and both packages refuse a mixed dense/sparse one."""
    path = write_moe_dir(tmp_path / "moe")
    jcfg, jparams = JP.load_pretrained_decoder(path, dtype="float32", attention_impl="xla",
                                               remat=False)
    tcfg, dec = TP.load_pretrained_decoder(path, device="cpu", dtype="float32",
                                           attention_impl="xla", remat=False)
    for f in dataclasses.fields(tcfg):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert (tcfg.num_experts, tcfg.moe_intermediate_size, tcfg.norm_topk_prob) == (4, 24, False)
    jl = jparams["layers"]["mlp"]
    for i, layer in enumerate(dec.layers):
        np.testing.assert_array_equal(layer.mlp.router.weight.detach().numpy(),
                                      np.asarray(jl["router"]["kernel"][i]).T)
        for n in ("gate", "up", "down"):
            np.testing.assert_array_equal(getattr(layer.mlp.experts, n).weight.detach().numpy(),
                                          np.asarray(jl["experts"][n][i]))
    ids = np.random.default_rng(12).integers(0, 96, (2, 10)).astype(np.int32)
    mask = np.ones_like(ids)
    want, _ = j_decoder_forward(jparams, jcfg, input_ids=jnp.asarray(ids),
                                attention_mask=jnp.asarray(mask))
    got, _ = t_decoder_forward(dec, tcfg, input_ids=torch.tensor(ids).long(),
                               attention_mask=torch.tensor(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5, rtol=0)
    mixed = write_moe_dir(tmp_path / "mixed", mixed=True)
    for load in (JP.decoder_config_from_hf, TP.decoder_config_from_hf):
        with pytest.raises(ValueError, match="mixed dense/sparse"):
            load(mixed)
