"""The port's int8 storage, W8A8, int8 KV cache and fused projections
(train/quant.py, train/fuse.py, models/layers.py, models/qwen3.py,
generate/engine.py) against the JAX package.

Tiny configs in fp32 on the CPU. One JAX tree, quantized and / or fused by
the JAX package, goes to both packages (`weights.from_jax_params` carries
int8 and fused leaves bit for bit). Quantization is held bit for bit, the
int8 x int8 product exactly, `dense` and `_w8a8_dot` at 1e-6 relative,
the int8 KV entries exactly, and the engine's greedy tokens token for token
under each serving flag and all of them together. JAX references are jitted
once and cached."""

import dataclasses
import functools

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
from bioreason_tpu.models import layers as JL
from bioreason_tpu.models.fusion import init_fusion as j_init
from bioreason_tpu.models.nt_encoder import encoder_forward as j_encoder_forward
from bioreason_tpu.models.qwen3 import decoder_forward as j_decoder_forward
from bioreason_tpu.models.qwen3 import init_cache as j_init_cache
from bioreason_tpu.train import fuse as JF
from bioreason_tpu.train import quant as JQ
from bioreason_tpu.train.lora import attach_lora as j_attach_lora
from bioreason_tpu_torch import config as TC
from bioreason_tpu_torch.generate.engine import GenerationEngine as TEngine
from bioreason_tpu_torch.models import layers as TL
from bioreason_tpu_torch.models.nt_encoder import encoder_forward as t_encoder_forward
from bioreason_tpu_torch.models.qwen3 import decoder_forward as t_decoder_forward
from bioreason_tpu_torch.models.qwen3 import init_cache as t_init_cache
from bioreason_tpu_torch.train import fuse as TF
from bioreason_tpu_torch.train import quant as TQ
from bioreason_tpu_torch.weights import from_jax_params

# one intra-op thread: the tensors here are tiny, and pytest-xdist runs
# several workers on the host's cores, which torch's default of a thread
# per core oversubscribes many times over
torch.set_num_threads(1)

TOK = JByte()
PROC = JProc(TOK, JKmer())
NEW = 10


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def base():
    """The JAX fusion tree (tiny, fp32) and both packages' configs."""
    jcfg = JC.FusionConfig.tiny(text_vocab=TOK.vocab_size, dna_pad_token_id=TOK.dna_pad_id)
    tcfg = TC.FusionConfig.tiny(text_vocab=TOK.vocab_size, dna_pad_token_id=TOK.dna_pad_id)
    return jcfg, np_tree(jax.jit(j_init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)), tcfg


def with_lora(tree):
    """LoRA on the decoder with non-zero B, so the adapters move the output."""
    lora = j_attach_lora(jax.random.PRNGKey(1), tree, JC.LoRAConfig(r=4, alpha=8))
    rng = np.random.default_rng(2)
    return jax.tree_util.tree_map_with_path(
        lambda p, x: (rng.standard_normal(np.shape(x)).astype(np.float32) * 0.1
                      if str(getattr(p[-1], "key", "")) == "lora_b" else np.asarray(x)), lora)


def tree_for(mode: str, lora: bool = False):
    """The JAX tree of a serving flag set: quantized first, then fused, as
    the JAX server does (serve.py:436-441)."""
    _, tree, _ = base()
    if lora:
        tree = with_lora(tree)
    if "int8" in mode or "w8a8" in mode or mode == "all":
        tree = JQ.quantize_frozen_int8(tree, include_embed=mode in ("int8_embed", "all"))
    if "fuse" in mode or mode == "all":
        tree = JF.fuse_projections(tree)
    return np_tree(tree)


def cfgs(w8a8=False):
    jcfg, _, tcfg = base()
    j = dataclasses.replace(jcfg, decoder=dataclasses.replace(jcfg.decoder, act_int8=w8a8),
                            encoder=dataclasses.replace(jcfg.encoder, act_int8=w8a8))
    t = dataclasses.replace(tcfg, decoder=dataclasses.replace(tcfg.decoder, act_int8=w8a8),
                            encoder=dataclasses.replace(tcfg.encoder, act_int8=w8a8))
    return j, t


# -- quantization, bit for bit ---------------------------------------------------

def kernel_with_edges(rng, n_in, n_out):
    """Random [in, out] kernel whose first column has absmax 127 (scale 1.0
    exactly) and halves to round (0.5 -> 0, 1.5 -> 2, 2.5 -> 2: half to
    even), and whose last column is zero (the 1e-12 clamp)."""
    w = rng.standard_normal((n_in, n_out)).astype(np.float32)
    w[:, 0] = 0.25
    w[:5, 0] = [127.0, 0.5, 1.5, 2.5, -2.5]
    w[:, -1] = 0.0
    return w


def test_quantize_kernel_and_embedding_bit_for_bit():
    rng = np.random.default_rng(0)
    w = kernel_with_edges(rng, 24, 16)                     # JAX [in, out]
    jk = JQ.quantize_kernel_int8(w)
    q, s = TQ.quantize_kernel_int8(torch.from_numpy(w.T.copy()))   # port [out, in]
    np.testing.assert_array_equal(q.numpy(), np.asarray(jk["q"]).T)
    np.testing.assert_array_equal(s.numpy(), np.asarray(jk["scale"]).T)
    assert q[0, :5].tolist() == [127, 0, 2, 2, -2] and bool((q[-1] == 0).all())
    e = kernel_with_edges(rng, 16, 24).T.copy()            # [V, H] in both
    je = JQ.quantize_embedding_int8(e)
    q, s = TQ.quantize_embedding_int8(torch.from_numpy(e))
    np.testing.assert_array_equal(q.numpy(), np.asarray(je["q"]))
    np.testing.assert_array_equal(s.numpy(), np.asarray(je["scale"]))
    np.testing.assert_array_equal(TQ.dequantize_kernel(q, s).numpy(),
                                  np.asarray(JQ.dequantize_kernel(je)))


@pytest.mark.parametrize("include_embed", [False, True])
def test_quantize_frozen_int8_matches_the_jax_tree(include_embed):
    """The port's quantization of a model equals the JAX tree's quantization
    carried over; the float weights are gone, not kept beside the int8."""
    _, tree, tcfg = base()
    model = TQ.quantize_frozen_int8(from_jax_params(tree, tcfg, device="cpu"),
                                    include_embed=include_embed)
    ref = from_jax_params(np_tree(JQ.quantize_frozen_int8(tree, include_embed=include_embed)),
                          tcfg, device="cpu")
    got, want = model.state_dict(), ref.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    lins = [m for m in model.decoder.modules() if isinstance(m, torch.nn.Linear)]
    assert all(m.weight.dtype == torch.int8 and "weight" not in m._parameters for m in lins)
    assert (model.decoder.embed.weight.dtype == torch.int8) == include_embed
    assert model.dna_projection.weight.dtype == torch.float32
    full = TQ.storage_bytes(from_jax_params(tree, tcfg, device="cpu").decoder.layers)
    assert TQ.storage_bytes(model.decoder.layers) < 0.3 * full      # fp32 -> int8 + scales


# -- dense on int8 and W8A8 --------------------------------------------------------

@pytest.mark.parametrize("rows", [3, 40])
def test_int8_product_is_exact(rows):
    """torch._int_mm with its row padding (<= 16 rows) against int64 numpy."""
    rng = np.random.default_rng(rows)
    xq = rng.integers(-127, 128, (rows, 64)).astype(np.int8)
    wq = rng.integers(-127, 128, (24, 64)).astype(np.int8)
    got = TL.int8_mm(torch.from_numpy(xq), torch.from_numpy(wq))
    assert got.dtype == torch.int32 and got.shape == (rows, 24)
    np.testing.assert_array_equal(got.numpy(), xq.astype(np.int64) @ wq.astype(np.int64).T)


@pytest.mark.parametrize("act8", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_dense_on_int8_matches_jax(act8, bias):
    rng = np.random.default_rng(3)
    w = rng.standard_normal((32, 24)).astype(np.float32)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32) * 3
    x[0, 0] = 0.0                                  # a zero token: the 1e-12 clamp
    b = rng.standard_normal(24).astype(np.float32)
    jp = {"kernel": JQ.quantize_kernel_int8(w), **({"bias": b} if bias else {})}
    want = np.asarray(jax.jit(JL.dense, static_argnums=(2, 3, 4))(
        jp, jnp.asarray(x), jnp.float32, None, act8))
    lin = TL.linear(32, 24, bias)
    TQ.store_int8(lin, *TQ.quantize_kernel_int8(torch.from_numpy(w.T.copy())))
    if bias:
        lin.bias.data = torch.from_numpy(b)
    got = TL.dense(lin, torch.from_numpy(x), torch.float32, act8=act8).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


# -- fused projections ----------------------------------------------------------------

@pytest.mark.parametrize("int8", [False, True])
def test_fuse_unfuse_round_trip_and_the_jax_layout(int8):
    _, tree, tcfg = base()
    model = from_jax_params(tree, tcfg, device="cpu")
    if int8:
        TQ.quantize_frozen_int8(model)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    TF.fuse_projections(model)
    TF.fuse_projections(model)                              # idempotent
    layer = model.decoder.layers[0]
    assert hasattr(layer.attn, "qkv") and not hasattr(layer.attn, "q")
    assert hasattr(layer.mlp, "gateup") and not hasattr(layer.mlp, "gate")
    jtree = JQ.quantize_frozen_int8(tree) if int8 else tree
    ref = from_jax_params(np_tree(JF.fuse_projections(jtree)), tcfg, device="cpu")
    assert {k: v.dtype for k, v in model.state_dict().items()} == {
        k: v.dtype for k, v in ref.state_dict().items()}
    for k, v in ref.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    TF.unfuse_projections(model)
    after = model.state_dict()
    assert sorted(after) == sorted(before)
    for k, v in before.items():
        assert torch.equal(after[k], v), k


def test_fuse_refuses_mixed_groups():
    _, tree, tcfg = base()
    model = from_jax_params(tree, tcfg, device="cpu")
    attn = model.decoder.layers[0].attn
    TQ.store_int8(attn.q, *TQ.quantize_kernel_int8(attn.q.weight))
    with pytest.raises(ValueError, match="mixed int8/float"):
        TF.fuse_projections(model, ("decoder",))
    model = from_jax_params(tree, tcfg, device="cpu")
    model.encoder.layers[0].attn.q.bias = None
    with pytest.raises(ValueError, match="mixed bias"):
        TF.fuse_projections(model, ("encoder",))


@pytest.mark.parametrize("int8", [False, True])
def test_fused_forward_equals_unfused_with_lora_on_the_splits(int8):
    """Decoder (LoRA on every projection) and NT encoder (biases) forwards:
    the fused port model equals the unfused one and the JAX fused tree's
    forward, the adapters added to the split outputs."""
    jcfg, _, tcfg = base()
    mode = "int8_fuse" if int8 else "fuse"
    plain = from_jax_params(tree_for("int8" if int8 else "plain", lora=True), tcfg, device="cpu")
    jtree = tree_for(mode, lora=True)
    fused = from_jax_params(jtree, tcfg, device="cpu")
    attn = fused.decoder.layers[0].attn
    assert isinstance(attn.q, TL.Adapter) and hasattr(attn, "qkv")
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 256, (2, 12)).astype(np.int32)
    want, _ = jax.jit(j_decoder_forward, static_argnums=1)(jtree["decoder"], jcfg.decoder,
                                                           jnp.asarray(ids))
    with torch.no_grad():
        got, _ = t_decoder_forward(fused.decoder, tcfg.decoder, torch.from_numpy(ids))
        unf, _ = t_decoder_forward(plain.decoder, tcfg.decoder, torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), unf.numpy(), atol=1e-5, rtol=0)
    dna = rng.integers(6, 100, (2, 16)).astype(np.int32)
    mask = np.ones((2, 16), np.int32)
    mask[1, 11:] = 0
    want = jax.jit(j_encoder_forward, static_argnums=1)(jtree["encoder"], jcfg.encoder,
                                                        jnp.asarray(dna), jnp.asarray(mask))
    with torch.no_grad():
        got = t_encoder_forward(fused.encoder, tcfg.encoder, torch.from_numpy(dna),
                                torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy()[mask.astype(bool)],
                               np.asarray(want)[mask.astype(bool)], atol=1e-5, rtol=0)


# -- the int8 KV cache ------------------------------------------------------------------

def test_kv_int8_cache_entries_equal_jax():
    """A left-padded prefill into an int8 cache (over its own float K/V),
    then two decode steps reading it: every int8 entry equal; the scales
    (absmax of K / V that two fp32 products round differently) at 1e-5
    relative, the logits at 1e-5."""
    jcfg, tree, tcfg = base()
    model = from_jax_params(tree, tcfg, device="cpu")
    rng = np.random.default_rng(5)
    b, p, s = 2, 9, 12
    ids = rng.integers(0, 256, (b, p)).astype(np.int32)
    mask = np.ones((b, p), np.int32)
    mask[1, :3] = 0
    cmask = np.pad(mask, ((0, 0), (0, s - p)))
    pos = np.maximum(np.cumsum(mask, -1) - 1, 0).astype(np.int32)

    @jax.jit
    def jrun(dec, ids, mask, cmask, pos, nxt):
        cache = j_init_cache(jcfg.decoder, b, s, jnp.float32, quantize=True)
        out = [j_decoder_forward(dec, jcfg.decoder, input_ids=ids, attention_mask=mask,
                                 positions=pos, cache=cache, cache_index=0,
                                 cache_mask=cmask)]
        for j in range(2):
            cmask = cmask.at[:, p + j].set(1)
            out.append(j_decoder_forward(
                dec, jcfg.decoder, input_ids=nxt[:, j:j + 1],
                attention_mask=jnp.ones((b, 1), jnp.int32),
                positions=pos[:, -1:] + 1 + j, cache=out[-1][1], cache_index=p + j,
                cache_mask=cmask))
        return [o[0] for o in out], out[-1][1]

    nxt = rng.integers(0, 256, (b, 2)).astype(np.int32)
    jlogits, jcache = jrun(tree["decoder"], ids, mask, cmask, pos, nxt)
    t = torch.from_numpy
    cache = t_init_cache(tcfg.decoder, b, s, torch.float32, quantize=True)
    cm = t(cmask).clone()
    with torch.no_grad():
        logits = [t_decoder_forward(model.decoder, tcfg.decoder, input_ids=t(ids),
                                    attention_mask=t(mask), positions=t(pos).long(),
                                    cache=cache, cache_index=0, cache_mask=cm)[0]]
        for j in range(2):
            cm[:, p + j] = 1
            logits.append(t_decoder_forward(
                model.decoder, tcfg.decoder, input_ids=t(nxt[:, j:j + 1]),
                attention_mask=torch.ones((b, 1), dtype=torch.int32),
                positions=t(pos[:, -1:]).long() + 1 + j, cache=cache, cache_index=p + j,
                cache_mask=cm)[0])
    for got, want in zip(cache, jcache):
        assert got["k"].dtype == torch.int8
        for n in ("k", "v"):
            np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))
            np.testing.assert_allclose(got[f"{n}_scale"].numpy(), np.asarray(want[f"{n}_scale"]),
                                       rtol=1e-5, atol=0)
    valid = np.concatenate([mask, np.ones((b, 2), np.int32)], 1).astype(bool)
    full = np.concatenate([np.asarray(jlogits[0])] + [np.asarray(x) for x in jlogits[1:]], 1)
    mine = torch.cat(logits, 1).numpy()
    np.testing.assert_allclose(mine[valid], full[valid], atol=1e-5, rtol=0)


# -- the engine under each serving flag ------------------------------------------------------

PROMPTS = ["what pathway does this variant disrupt?", "short", "a dna question here"]


def prompt_batch():
    out = PROC(text=PROMPTS, batch_dna_sequences=[["ACGTACGTAC"], ["GGCATTACA"], ["TTAGC"]],
               max_length_text=64, max_length_dna=16, padding_side="left")
    return out.input_ids, out.attention_mask, out.dna_input_ids, out.dna_attention_mask


MODES = {"int8": ("int8", False, False), "int8_embed": ("int8_embed", False, False),
         "kv_int8": ("plain", True, False), "fuse": ("fuse", False, False),
         "w8a8": ("int8", False, True), "all": ("all", True, True)}


@functools.lru_cache(maxsize=None)
def jax_tokens(mode):
    tree_mode, kv8, w8 = MODES[mode]
    jcfg, _ = cfgs(w8)
    engine = JEngine(jcfg, eos_token_id=-1, kv_int8=kv8)
    ids, _ = engine.generate(tree_for(tree_mode), *prompt_batch(), greedy=True,
                             max_new_tokens=NEW)
    return ids


@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_greedy_tokens_match_jax_under_each_serving_flag(mode):
    tree_mode, kv8, w8 = MODES[mode]
    _, tcfg = cfgs(w8)
    model = from_jax_params(tree_for(tree_mode), tcfg, device="cpu")
    engine = TEngine(tcfg, eos_token_id=-1, device="cpu", kv_int8=kv8)
    ids, _ = engine.generate(model, *prompt_batch(), greedy=True, max_new_tokens=NEW)
    np.testing.assert_array_equal(ids, jax_tokens(mode))


@pytest.mark.parametrize("tree_mode", ["plain", "int8_embed"])
def test_kv_int8_refuses_grouped_decode(tree_mode):
    """The grouped int8-KV decode (ported: it no longer refuses G > 1):
    greedy grouped tokens on an int8 KV cache, over float and over int8
    weights, equal the JAX engine's, and each group's rows agree."""
    jcfg, tcfg = cfgs()
    model = from_jax_params(tree_for(tree_mode), tcfg, device="cpu")
    engine = TEngine(tcfg, eos_token_id=-1, device="cpu", kv_int8=True)
    ids, _ = engine.generate(model, *prompt_batch(), greedy=True, max_new_tokens=NEW,
                             group_size=2)
    want, _ = JEngine(jcfg, eos_token_id=-1, kv_int8=True).generate(
        tree_for(tree_mode), *prompt_batch(), greedy=True, max_new_tokens=NEW, group_size=2)
    np.testing.assert_array_equal(ids, want)
    assert (ids[0::2] == ids[1::2]).all()
