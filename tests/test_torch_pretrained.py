"""The port on pretrained weights, against the JAX package and the HF
libraries: the safetensors reader and writer, the HF import of Qwen3 and
NT-v2 / ESM directories into the port's modules, the byte-level BPE on the
standard library, the reference-format SFT checkpoints, the variant-effect
and LLM-only formatting, the frozen storage dtype of per-layer leaves, the
`train_sft`, `reason` and `serve --checkpoint` paths from HF directories,
and the provenance of an `sft_final` trained on a pretrained base.

The HF directories are tiny and written here from a seed: a Qwen3
directory (config.json, fp32 safetensors with non-unit norm scales, a
byte-level `tokenizer.json` with Qwen's Split regex built by `tokenizers`)
and an NT-v2-layout ESM directory (rotary, the fused gated MLP without
biases, non-zero attention biases and layer-norm shifts, vocab.txt). Their
q/k/v/o projections are square and random, so a transposed import would
run and disagree. JAX runs are compiled whole and cached.
"""

import dataclasses
import functools
import json
import math
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from bioreason_tpu import config as JC
from bioreason_tpu.cli import common as JCommon
from bioreason_tpu.data import collate as JD
from bioreason_tpu.data.processor import BioProcessor as JProc
from bioreason_tpu.parallel import make_mesh
from bioreason_tpu.train.sft import SFTTrainer as JTrainer
from bioreason_tpu.utils import pretrained as JP
from bioreason_tpu_torch import config as TC
from bioreason_tpu_torch.train.sft import SFTTrainer
from bioreason_tpu_torch.utils import pretrained as TP
from bioreason_tpu_torch.weights import from_jax_params

# one intra-op thread: the tensors here are tiny, and pytest-xdist runs
# several workers on the host's cores, which torch's default of a thread
# per core oversubscribes many times over
torch.set_num_threads(1)

tokenizers = pytest.importorskip("tokenizers")
safetensors_np = pytest.importorskip("safetensors.numpy")

QWEN_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"
              r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
H, I_DEC, I_ENC, HEADS, KV, HD, LAYERS = 32, 48, 48, 4, 2, 8, 2
NT_VOCAB = (["<unk>", "<pad>", "<mask>", "<cls>", "<eos>", "<bos>"]
            + [a + b for a in "ACGT" for b in "ACGT"] + ["A", "C", "G", "T", "N"])


def _merges_vocab():
    alphabet = sorted(tokenizers.pre_tokenizers.ByteLevel.alphabet())
    vocab = {ch: i for i, ch in enumerate(alphabet)}
    merges = []
    for a, b in [("A", "C"), ("G", "T"), ("AC", "GT"), ("Ġ", "t"), ("h", "e"), ("Ġt", "he"),
                 ("i", "n"), ("Ġ", "a"), ("e", "r"), ("o", "n"), ("Ġ", "s"), ("a", "t"),
                 ("r", "e"), ("e", "n"), ("Ġ", "p"), ("a", "y"), ("w", "ay")]:
        merged = a + b
        if merged not in vocab:
            vocab[merged] = len(vocab)
        merges.append((a, b))
    return vocab, merges


def write_tokenizer(path, split=QWEN_SPLIT):
    """A Qwen2-style byte-level tokenizer.json (Split regex + ByteLevel)
    with Qwen's special tokens and <think> / </think> as added tokens."""
    from tokenizers import Regex, Tokenizer
    from tokenizers.decoders import ByteLevel as ByteLevelDecoder
    from tokenizers.models import BPE
    from tokenizers.pre_tokenizers import ByteLevel, Sequence, Split
    from transformers import PreTrainedTokenizerFast
    vocab, merges = _merges_vocab()
    raw = Tokenizer(BPE(vocab=vocab, merges=merges))
    raw.pre_tokenizer = Sequence([Split(Regex(split), behavior="isolated"),
                                  ByteLevel(add_prefix_space=False, use_regex=False)])
    raw.decoder = ByteLevelDecoder()
    hf = PreTrainedTokenizerFast(tokenizer_object=raw)
    hf.add_special_tokens({"eos_token": "<|im_end|>",
                           "additional_special_tokens": ["<|endoftext|>", "<|im_start|>"]})
    hf.add_tokens(["<think>", "</think>"])
    hf.save_pretrained(path)
    return hf


def _norm(rng, shape):
    return (1.0 + 0.2 * rng.standard_normal(shape)).astype(np.float32)


def _w(rng, shape, scale=0.3):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def write_qwen3_dir(path, seed=0, slack=8):
    """config.json + model.safetensors (fp32, non-unit norm scales, tied
    embeddings, the vocab padded `slack` rows past the tokenizer) +
    tokenizer files."""
    os.makedirs(path, exist_ok=True)
    hf = write_tokenizer(path)
    vocab = len(hf) + slack
    rng = np.random.default_rng(seed)
    state = {"model.embed_tokens.weight": _w(rng, (vocab, H), 0.5),
             "model.norm.weight": _norm(rng, (H,))}
    for i in range(LAYERS):
        p = f"model.layers.{i}."
        state.update({
            p + "self_attn.q_proj.weight": _w(rng, (HEADS * HD, H)),
            p + "self_attn.k_proj.weight": _w(rng, (KV * HD, H)),
            p + "self_attn.v_proj.weight": _w(rng, (KV * HD, H)),
            p + "self_attn.o_proj.weight": _w(rng, (H, HEADS * HD)),
            p + "self_attn.q_norm.weight": _norm(rng, (HD,)),
            p + "self_attn.k_norm.weight": _norm(rng, (HD,)),
            p + "input_layernorm.weight": _norm(rng, (H,)),
            p + "post_attention_layernorm.weight": _norm(rng, (H,)),
            p + "mlp.gate_proj.weight": _w(rng, (I_DEC, H)),
            p + "mlp.up_proj.weight": _w(rng, (I_DEC, H)),
            p + "mlp.down_proj.weight": _w(rng, (H, I_DEC))})
    safetensors_np.save_file(state, os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"architectures": ["Qwen3ForCausalLM"], "model_type": "qwen3",
                   "vocab_size": vocab, "hidden_size": H, "intermediate_size": I_DEC,
                   "num_hidden_layers": LAYERS, "num_attention_heads": HEADS,
                   "num_key_value_heads": KV, "head_dim": HD, "rope_theta": 10000.0,
                   "rms_norm_eps": 1e-6, "tie_word_embeddings": True}, f)
    return state


def write_nt_dir(path, seed=1):
    """An NT-v2-layout ESM directory: rotary, the gated MLP fused into one
    `intermediate.dense` [2I, H] without biases (add_bias_fnn=False),
    non-zero attention biases and layer-norm shifts, non-unit scales, an
    MLM head the import ignores, a 2-mer vocab.txt."""
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    v = len(NT_VOCAB)
    state = {"esm.embeddings.word_embeddings.weight": _w(rng, (v, H), 0.5),
             "esm.encoder.emb_layer_norm_after.weight": _norm(rng, (H,)),
             "esm.encoder.emb_layer_norm_after.bias": _w(rng, (H,), 0.1),
             "lm_head.dense.weight": _w(rng, (H, H)), "lm_head.bias": _w(rng, (v,))}
    for i in range(LAYERS):
        p = f"esm.encoder.layer.{i}."
        for name in ("attention.self.query", "attention.self.key", "attention.self.value",
                     "attention.output.dense"):
            state[p + name + ".weight"] = _w(rng, (H, H))
            state[p + name + ".bias"] = _w(rng, (H,), 0.1)
        for name in ("attention.LayerNorm", "LayerNorm"):
            state[p + name + ".weight"] = _norm(rng, (H,))
            state[p + name + ".bias"] = _w(rng, (H,), 0.1)
        state[p + "intermediate.dense.weight"] = _w(rng, (2 * I_ENC, H))
        state[p + "output.dense.weight"] = _w(rng, (H, I_ENC))
        state[p + "attention.self.rotary_embeddings.inv_freq"] = np.ones(HD // 2, np.float32)
    safetensors_np.save_file(state, os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "vocab.txt"), "w") as f:
        f.write("\n".join(NT_VOCAB))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"architectures": ["EsmForMaskedLM"], "model_type": "esm",
                   "vocab_size": v, "hidden_size": H, "intermediate_size": I_ENC,
                   "num_hidden_layers": LAYERS, "num_attention_heads": HEADS,
                   "position_embedding_type": "rotary", "layer_norm_eps": 1e-12,
                   "add_bias_fnn": False, "token_dropout": False, "mask_token_id": 2}, f)
    return state


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("hf")
    qwen, nt = str(root / "qwen3"), str(root / "nt")
    write_qwen3_dir(qwen)
    write_nt_dir(nt)
    return qwen, nt


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def unflat(d):
    out = {}
    for k, v in d.items():
        node = out
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def jax_fusion(qwen, nt, dtype="float32"):
    cfg, params, tok, dna_tok = JP.load_pretrained_fusion(qwen, nt, max_length_text=256,
                                                          max_length_dna=64, dtype=dtype)
    return cfg, jax.tree.map(np.asarray, params), tok, dna_tok


def port_cfg(jcfg, **dec):
    """The port's FusionConfig with the JAX one's fields."""
    def conv(c, cls):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in dataclasses.asdict(c).items() if k in names})
    return TC.FusionConfig(decoder=dataclasses.replace(conv(jcfg.decoder, TC.DecoderConfig), **dec),
                           encoder=conv(jcfg.encoder, TC.EncoderConfig),
                           dna_pad_token_id=jcfg.dna_pad_token_id,
                           max_length_text=jcfg.max_length_text,
                           max_length_dna=jcfg.max_length_dna)


# -- fault 1: the frozen storage dtype of per-layer leaves --------------------------

LORA = dict(r=4, alpha=8, dropout=0.0)


def sft_cfg(C, **kw):
    return C.SFTConfig(batch_size=2, max_length_dna=64, bucket=None,
                       optim=C.OptimConfig(learning_rate=1e-2, total_steps=20, warmup_ratio=0.0,
                                           eps=1e-3),
                       lora=C.LoRAConfig(**LORA), **kw)


def variant_items(n, seed, seq_len=40):
    """Variant-effect records as data/variant_effect.py reads them: two
    sequences, a question, an answer with a ';' tail."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        ref = "".join(rng.choice(list("ACGT"), seq_len))
        pos = int(rng.integers(0, seq_len))
        var = ref[:pos] + "ACGT"[(("ACGT".index(ref[pos])) + 1) % 4] + ref[pos + 1:]
        out.append({"question": f"Is variant {k} at {pos} benign or pathogenic?",
                    "answer": ("Pathogenic; reviewed" if k % 2 else "Benign"),
                    "reference_sequence": ref, "variant_sequence": var})
    return out


def jax_batch(tok, dna_tok, seed, n=2):
    """A JAX-collated batch of `n` coding variant-effect items."""
    from bioreason_tpu.data.variant_effect import (clean_variant_effect_example,
                                                   format_variant_effect_for_dna_llm)
    exs = [format_variant_effect_for_dna_llm(clean_variant_effect_example(dict(x)))
           for x in variant_items(n, seed)]
    return JD.sft_collate(exs, JProc(tok, dna_tok), 256, 64, bucket=None)


@functools.lru_cache(maxsize=None)
def jax_frozen_run(qwen, nt, freeze_encoder):
    """The JAX SFTTrainer from the HF pair with frozen_dtype bf16: the
    fp32 imported tree, the trainer's adapters and projection at init, and
    each of two steps' metrics."""
    jcfg, params, tok, dna_tok = jax_fusion(qwen, nt)
    jsft = sft_cfg(JC, frozen_dtype="bfloat16", freeze_encoder=freeze_encoder)
    trainer = JTrainer(jcfg, jsft, mesh=make_mesh(JC.MeshConfig(data=1), devices=jax.devices()[:1]),
                       params=jax.tree.map(np.copy, params))
    init = flat(jax.tree.map(np.asarray, trainer.params))
    metrics = [trainer.train_step(jax_batch(tok, dna_tok, s)) for s in (30, 31)]
    return jcfg, params, init, metrics, tok, dna_tok


@pytest.mark.parametrize("freeze_encoder", [True, False])
def test_frozen_per_layer_leaves_are_stored_as_jax_stores_them(hf_dirs, freeze_encoder):
    """Two SFT steps from the HF pair (non-unit norm scales, non-zero
    biases) with bf16 frozen storage agree with the JAX trainer at 1e-5:
    the port stores every frozen fp32 leaf that JAX stacks [L, ...] (the
    decoder's norms and q/k norms; NT's norms and biases) in bf16, as JAX's
    ndim >= 2 rule does, and keeps the final norms fp32."""
    jcfg, params, init, metrics, tok, dna_tok = jax_frozen_run(*hf_dirs, freeze_encoder)
    # the fp32 import with the JAX trainer's adapters and projection
    tree = flat(params)
    tree.update({k: v for k, v in init.items()
                 if k.rsplit("/", 1)[-1].startswith("lora_") or k.startswith("dna_projection")})
    tcfg = port_cfg(jcfg)
    model = from_jax_params(unflat(tree), tcfg, device="cpu")
    trainer = SFTTrainer(tcfg, sft_cfg(TC, frozen_dtype="bfloat16",
                                       freeze_encoder=freeze_encoder),
                         model=model, device="cpu")
    dt = {n: p.dtype for n, p in trainer.model.named_parameters()}
    assert dt["decoder.layers.0.ln1.scale"] == torch.bfloat16
    assert dt["decoder.layers.1.attn.k_norm.scale"] == torch.bfloat16
    assert dt["decoder.final_norm.scale"] == torch.float32
    enc_dt = torch.bfloat16 if freeze_encoder else torch.float32
    assert dt["encoder.layers.0.attn.q.bias"] == enc_dt
    assert dt["encoder.layers.1.ln2.bias"] == enc_dt
    assert dt["encoder.final_norm.scale"] == torch.float32
    for s, jm in zip((30, 31), metrics):
        m = trainer.train_step(jax_batch(tok, dna_tok, s))
        assert math.isfinite(m["loss"])
        assert m["loss"] == pytest.approx(jm["loss"], rel=1e-5)
        assert m["grad_norm"] == pytest.approx(jm["grad_norm"], rel=1e-5)


# -- safetensors --------------------------------------------------------------------

ST_DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.int64, torch.int32,
             torch.uint8, torch.bool]


def _tensor(dtype, shape, seed):
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.bool:
        return torch.rand(shape, generator=g) > 0.5
    if dtype.is_floating_point:
        return torch.randn(shape, generator=g).to(dtype)
    return torch.randint(0, 200, shape, generator=g).to(dtype)


def _same(a, b):
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype in (torch.bfloat16, torch.float16):
        return torch.equal(a.view(torch.int16), b.view(torch.int16))
    return torch.equal(a, b)


@pytest.mark.parametrize("dtype", ST_DTYPES, ids=lambda d: str(d).split(".")[1])
def test_safetensors_reader_and_writer_match_the_library(tmp_path, dtype):
    """Files the `safetensors` library writes read back bit for bit through
    the port's reader, and files the port writes read back bit for bit
    through the library, for every supported dtype, next to a tensor of
    another width (alignment), a scalar and an empty tensor."""
    from safetensors.torch import load_file as lib_load, save_file as lib_save
    from bioreason_tpu_torch.utils import safetensors_io as S
    tensors = {"x": _tensor(dtype, (3, 5), 0), "odd": _tensor(torch.uint8, (7,), 1),
               "scalar": _tensor(dtype, (), 2), "empty": _tensor(dtype, (0, 4), 3),
               "wide": _tensor(torch.float32, (2, 3), 4)}
    lib_save(tensors, str(tmp_path / "lib.safetensors"))
    S.save_file(tensors, str(tmp_path / "port.safetensors"), metadata={"format": "pt"})
    for got in (S.load_file(str(tmp_path / "lib.safetensors")),
                lib_load(str(tmp_path / "port.safetensors"))):
        assert sorted(got) == sorted(tensors)
        for k, t in tensors.items():
            assert _same(got[k], t), k
    header, _ = S.read_header(str(tmp_path / "port.safetensors"))
    assert header["__metadata__"] == {"format": "pt"}


def test_header_fingerprint_sees_a_changed_layout(tmp_path):
    from bioreason_tpu_torch.utils import safetensors_io as S
    S.save_file({"a": torch.zeros(4, 4)}, str(tmp_path / "a.safetensors"))
    S.save_file({"a": torch.ones(4, 4)}, str(tmp_path / "b.safetensors"))
    S.save_file({"a": torch.zeros(2, 8)}, str(tmp_path / "c.safetensors"))
    fa, fb, fc = (S.header_fingerprint(str(tmp_path / f"{n}.safetensors")) for n in "abc")
    assert fa == fb and fa != fc


def test_load_hf_state_dict_reads_shards_in_order_and_bin_files(tmp_path, hf_dirs):
    """Sorted safetensors shards, else `pytorch_model*.bin` through
    torch.load(weights_only=True), as the JAX loader reads them."""
    from bioreason_tpu.utils.hf_import import load_hf_state_dict as j_load
    from bioreason_tpu_torch.utils import safetensors_io as S
    from bioreason_tpu_torch.utils.hf_import import load_hf_state_dict
    qwen, _ = hf_dirs
    state = load_hf_state_dict(qwen)
    names = sorted(state)
    shards = tmp_path / "shards"
    shards.mkdir()
    S.save_file({k: state[k] for k in names[::2]}, str(shards / "model-00002.safetensors"))
    S.save_file({k: state[k] for k in names[1::2]}, str(shards / "model-00001.safetensors"))
    bins = tmp_path / "bins"
    bins.mkdir()
    torch.save({k: state[k].clone() for k in names}, str(bins / "pytorch_model.bin"))
    want = j_load(qwen)
    for d in (shards, bins):
        got = load_hf_state_dict(str(d))
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


# -- the HF import ------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hf_import_matches_from_jax_params(hf_dirs, dtype):
    """Every parameter of the port's `load_pretrained_fusion` equals the JAX
    loader's tree through `from_jax_params`, bit for bit and in the same
    dtype, but the DNA projection, which both draw fresh from their own
    generators (N(0, 1/d), zero bias); the configs and tokenizer ids agree."""
    qwen, nt = hf_dirs
    jcfg, params, jtok, jdna = jax_fusion(qwen, nt, dtype)
    cfg, model, tok, dna_tok = TP.load_pretrained_fusion(qwen, nt, 256, 64, dtype=dtype,
                                                         device="cpu")
    assert cfg == port_cfg(jcfg)
    assert (tok.dna_start_id, tok.dna_pad_id, tok.dna_end_id, tok.eos_token_id) == (
        jtok.dna_start_id, jtok.dna_pad_id, jtok.dna_end_id, jtok.eos_token_id)
    assert dna_tok.vocab == jdna.vocab and cfg.encoder.use_swiglu and not cfg.encoder.mlp_bias
    want = dict(from_jax_params(params, cfg, device="cpu").named_parameters())
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(want)
    for name, p in got.items():
        if name.startswith("dna_projection"):
            continue
        assert p.dtype == want[name].dtype and torch.equal(p, want[name]), name
    w = got["dna_projection.weight"]
    assert w.shape == (H, H) and abs(float(w.detach().std()) * H ** 0.5 - 1) < 0.2
    assert not got["dna_projection.bias"].any()


@functools.lru_cache(maxsize=None)
def jax_fused_logits(qwen, nt):
    from bioreason_tpu.models.fusion import fusion_forward
    jcfg, params, tok, dna_tok = jax_fusion(qwen, nt)
    batch = jax_batch(tok, dna_tok, 40)
    keys = ("input_ids", "attention_mask", "dna_input_ids", "dna_attention_mask")
    fwd = jax.jit(lambda p, *a: fusion_forward(p, jcfg, *a)[0])
    with jax.default_matmul_precision("highest"):
        logits = fwd(params, *(batch[k] for k in keys))
    return np.asarray(logits), batch


def test_fused_logits_match_jax(hf_dirs):
    """The fused forward of the imported model (NT encoder, splice, Qwen3
    decoder) at fp32 against the JAX package's on the same batch, with
    JAX's projection copied in: 1e-5 relative to the largest logit."""
    from bioreason_tpu_torch.models.fusion import fusion_forward
    qwen, nt = hf_dirs
    want, batch = jax_fused_logits(qwen, nt)
    _, params, _, _ = jax_fusion(qwen, nt)
    cfg, model, _, _ = TP.load_pretrained_fusion(qwen, nt, 256, 64, dtype="float32",
                                                 device="cpu")
    with torch.no_grad():
        model.dna_projection.weight.copy_(torch.from_numpy(params["dna_projection"]["kernel"].T))
        args = [torch.from_numpy(np.asarray(batch[k])) for k in
                ("input_ids", "attention_mask", "dna_input_ids", "dna_attention_mask")]
        got, _ = fusion_forward(model, cfg, *args)
    valid = np.asarray(batch["attention_mask"]).astype(bool)
    scale = np.abs(want[valid]).max()
    np.testing.assert_allclose(got.numpy()[valid], want[valid], atol=1e-5 * scale, rtol=0)


def test_esm_gelu_layout_and_the_committed_nt_fixture_import_as_jax(tmp_path):
    """An `EsmForMaskedLM` written by transformers (plain gelu MLP with
    biases) and the committed NT-v2 fixture (fused gated MLP, no MLP bias)
    import into the port's encoder as the JAX importer's tree converts:
    bit for bit, the layout read from the keys."""
    from transformers import EsmConfig, EsmForMaskedLM
    from bioreason_tpu.utils.hf_import import import_esm as j_import, load_hf_state_dict as j_load
    from bioreason_tpu_torch.config import EncoderConfig
    from bioreason_tpu_torch.models.nt_encoder import NTEncoder
    from bioreason_tpu_torch.utils.hf_import import esm_layout, import_esm, load_hf_state_dict
    from bioreason_tpu_torch.weights import _dense, _layer, _norm
    torch.manual_seed(1)
    ecfg = EsmConfig(vocab_size=11, hidden_size=24, intermediate_size=48, num_hidden_layers=2,
                     num_attention_heads=4, position_embedding_type="rotary",
                     token_dropout=False, max_position_embeddings=64, pad_token_id=1)
    EsmForMaskedLM(ecfg).save_pretrained(str(tmp_path))
    fixture = os.path.join(os.path.dirname(__file__), "assets", "nt_v2_tiny")
    for path, swiglu, hidden, inter, vocab in ((str(tmp_path), False, 24, 48, 11),
                                               (fixture, True, 32, 48, 32)):
        state = load_hf_state_dict(path)
        layout = esm_layout(state)
        assert layout["use_swiglu"] == swiglu and layout["attn_bias"]
        assert layout["mlp_bias"] == (not swiglu)
        cfg = EncoderConfig(vocab_size=vocab, hidden_size=hidden, intermediate_size=inter,
                            num_layers=2, num_heads=4, dtype="float32", **layout)
        enc = import_esm(state, NTEncoder(cfg))
        jt = j_import(j_load(path))
        ref = NTEncoder(cfg)
        with torch.no_grad():
            ref.embed.weight.copy_(torch.from_numpy(jt["embed"]["embedding"]))
            _norm(ref.final_norm, jt["final_norm"])
            for i, lm in enumerate(ref.layers):
                lp = _layer(jt["layers"], i)
                _norm(lm.ln1, lp["ln1"])
                _norm(lm.ln2, lp["ln2"])
                for name in ("q", "k", "v", "o"):
                    _dense(getattr(lm.attn, name), lp["attn"][name])
                for name, sub in lp["mlp"].items():
                    _dense(getattr(lm.mlp, name), sub)
        want = dict(ref.named_parameters())
        for name, p in enc.named_parameters():
            assert torch.equal(p, want[name]), (path, name)


def test_exports_invert_the_imports(hf_dirs):
    """`export_decoder_to_hf` and `export_encoder_to_hf` give back the
    files' tensors (the tied head aside; NT's gate and up fused again)."""
    from bioreason_tpu_torch.utils.hf_import import (export_decoder_to_hf, export_encoder_to_hf,
                                                     import_with_map, load_hf_state_dict,
                                                     ESM_RULES)
    qwen, nt = hf_dirs
    _, model, _, _ = TP.load_pretrained_fusion(qwen, nt, 256, 64, dtype="float32",
                                               device="cpu")
    for path, got in ((qwen, export_decoder_to_hf(model.decoder)),
                      (nt, export_encoder_to_hf(model.encoder))):
        state = load_hf_state_dict(path)
        if path == nt:                       # drop the MLM head and the rotary buffers
            state = {k: v for k, v in state.items()
                     if k.startswith("esm.") and "rotary" not in k}
        assert sorted(got) == sorted(state)
        for k, v in state.items():
            assert torch.equal(got[k], v), k
    assert len(import_with_map(load_hf_state_dict(nt), ESM_RULES)) == 3 + LAYERS * 14


def test_dna_tokens_must_fit_the_padded_vocab(tmp_path, hf_dirs):
    """A Qwen3 vocab with no slack past the tokenizer cannot take the DNA
    tokens without a resize: refused, as the JAX loader refuses it; a DNA
    tokenizer whose vocab differs from the encoder's is refused too."""
    _, nt = hf_dirs
    tight = str(tmp_path / "tight")
    write_qwen3_dir(tight, slack=0)
    for loader in (JP.load_pretrained_fusion,
                   functools.partial(TP.load_pretrained_fusion, device="cpu")):
        with pytest.raises(ValueError, match="does not fit"):
            loader(tight, nt)
    short = str(tmp_path / "nt_short")
    shutil.copytree(nt, short)
    with open(os.path.join(short, "vocab.txt"), "w") as f:
        f.write("\n".join(NT_VOCAB[:-1]))
    with pytest.raises(ValueError, match="vocab"):
        TP.load_pretrained_fusion(hf_dirs[0], short, device="cpu")


def test_kmer_tokenizer_from_the_vocab_file_matches_jax(hf_dirs):
    from bioreason_tpu.data.nt_tokenizer import KmerTokenizer as JKmer
    from bioreason_tpu_torch.data.nt_tokenizer import KmerTokenizer
    path = os.path.join(hf_dirs[1], "vocab.txt")
    seqs = ["ACGTNACGTTA", "GGC", "NNACGT", ""]
    got = KmerTokenizer.from_vocab_file(path)(seqs, max_length=8)
    want = JKmer.from_vocab_file(path)(seqs, max_length=8)
    for k in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(got[k], want[k])
    assert KmerTokenizer.from_vocab_file(path).vocab_size == len(NT_VOCAB)


# -- the byte-level BPE on the standard library -------------------------------------

BPE_TEXTS = [
    "hello world", "Hello, World!  multiple  spaces", "line\nbreaks\r\nand\ttabs",
    "unicode: café über 世界 \U0001f9ec", "numbers 12345 and mixed a1b2",
    "it's we're I'll they'd", "<|im_start|>user\nhi<|im_end|>\n", "trailing space ",
    " leading space", "", "ACGTACGT" * 8, "don't stop'", "a" * 100,
    "separators \x1c\x1d\x1e\x1f between", "Ⅻ roman ½ fractions ٣ digits",
    "<think>\nthe path</think>\n\nAnswer: apoptosis",
]


def kegg_prompts():
    from bioreason_tpu_torch.data.chat_template import apply_chat_template
    from bioreason_tpu_torch.data.kegg import format_kegg_for_dna_llm, synthetic_kegg_items
    exs = [format_kegg_for_dna_llm(x) for x in synthetic_kegg_items(3, seq_len=24, seed=5)]
    return [apply_chat_template(e)["prompt"] + apply_chat_template(e).get("completion", "")
            for e in exs]


def _bpe_dir(tmp_path, kind):
    from tokenizers import normalizers
    from tokenizers.pre_tokenizers import ByteLevel
    path = str(tmp_path / kind)
    if kind == "qwen":
        write_tokenizer(path)
        return path
    from tokenizers import Tokenizer
    from tokenizers.decoders import ByteLevel as ByteLevelDecoder
    from tokenizers.models import BPE
    from transformers import PreTrainedTokenizerFast
    vocab, merges = _merges_vocab()
    raw = Tokenizer(BPE(vocab=vocab, merges=merges))
    raw.pre_tokenizer = ByteLevel(add_prefix_space=False, use_regex=True)
    raw.decoder = ByteLevelDecoder()
    if kind == "nfc":
        raw.normalizer = normalizers.NFC()
    hf = PreTrainedTokenizerFast(tokenizer_object=raw)
    hf.add_special_tokens({"eos_token": "<|im_end|>",
                           "additional_special_tokens": ["<|im_start|>", "<|endoftext|>"]})
    hf.save_pretrained(path)
    return path


@pytest.mark.parametrize("kind", ["qwen", "gpt2", "nfc"])
def test_bpe_matches_jax_and_tokenizers(tmp_path, kind):
    """Ids and decodes (special tokens kept and skipped) equal to the JAX
    package's BPETokenizer and to HF's fast tokenizer, over the BPE tests'
    texts (U+001C..U+001F, letter-like numbers and non-Nd digits added) and
    chat-rendered KEGG examples."""
    from transformers import PreTrainedTokenizerFast
    from bioreason_tpu.data.bpe import BPETokenizer as JBPE
    from bioreason_tpu_torch.data.bpe import BPETokenizer
    path = _bpe_dir(tmp_path, kind)
    ours, jax_tok = BPETokenizer.from_dir(path), JBPE.from_dir(path)
    hf = PreTrainedTokenizerFast.from_pretrained(path)
    for text in BPE_TEXTS + kegg_prompts():
        ids = ours.encode(text)
        assert ids == jax_tok.encode(text) == hf.encode(text, add_special_tokens=False), text
        for skip in (False, True):
            assert ours.decode(ids, skip) == jax_tok.decode(ids, skip) == hf.decode(
                ids, skip_special_tokens=skip), text
    assert ours.vocab_size == jax_tok.vocab_size == len(hf)


@pytest.mark.parametrize("name", ["L", "N"])
def test_unicode_classes_match_regex(name):
    """`\\p{L}` / `\\p{N}` as the BPE reads them (the committed
    `data/unicode_classes.json`) against the `regex` module's, on every code
    point 0..0x10FFFF, those that only `regex`'s Unicode assigns included;
    and the file is what its generator writes from this `regex`."""
    import regex
    from bioreason_tpu_torch.data.bpe import compile_pattern, unicode_class
    from bioreason_tpu_torch.tools.unicode_classes import generate
    ours = set()
    for a, b in unicode_class(name):
        ours.update(range(a, b + 1))
    theirs = regex.compile(rf"\p{{{name}}}")
    bad = [c for c in range(0x110000) if (c in ours) != bool(theirs.match(chr(c)))]
    assert not bad, [hex(c) for c in bad[:8]]
    assert [tuple(r) for r in generate()[name]] == list(unicode_class(name))
    # the translated split pattern finds the same pieces as `regex`
    assigned = [c for c in range(0x110000) if regex.match(r"\P{Cn}", chr(c))]
    text = "".join(chr(c) for c in assigned[::997])
    assert ([m.group() for m in compile_pattern(QWEN_SPLIT).finditer(text)]
            == [m.group() for m in regex.compile(QWEN_SPLIT).finditer(text)])


@pytest.mark.parametrize("text", ["ab\u1c89cd", "v\U00010D40w"])
def test_bpe_pieces_and_ids_past_pythons_unicode_match_jax(tmp_path, text):
    """Code points that `regex`'s Unicode assigns and Python's does not
    (U+1C89, a letter; U+10D40, a number): the port's split on Qwen's
    pattern and its ids equal the JAX tokenizer's (ROADMAP 3, fault 1)."""
    import regex
    from bioreason_tpu.data.bpe import BPETokenizer as JBPE
    from bioreason_tpu_torch.data.bpe import BPETokenizer, compile_pattern
    pieces = [m.group() for m in compile_pattern(QWEN_SPLIT).finditer(text)]
    assert pieces == [m.group() for m in regex.compile(QWEN_SPLIT).finditer(text)]
    assert len(pieces) == (1 if text.startswith("ab") else 3)
    path = _bpe_dir(tmp_path, "qwen")
    ours, jax_tok = BPETokenizer.from_dir(path), JBPE.from_dir(path)
    assert ours.encode(text) == jax_tok.encode(text)
    assert ours.decode(ours.encode(text)) == text


def test_load_hf_tokenizer_adds_the_dna_tokens_as_jax_does(hf_dirs, tmp_path):
    from bioreason_tpu.data.text_tokenizer import load_hf_tokenizer as j_load
    from bioreason_tpu_torch.data.bpe import UnsupportedTokenizerError
    from bioreason_tpu_torch.data.text_tokenizer import load_hf_tokenizer
    ours, theirs = load_hf_tokenizer(hf_dirs[0]), j_load(hf_dirs[0])
    for attr in ("dna_start_id", "dna_pad_id", "dna_end_id", "eos_token_id", "pad_token_id",
                 "vocab_size"):
        assert getattr(ours, attr) == getattr(theirs, attr), attr
    text = "<|dna_start|><|dna_pad|><|dna_pad|><|dna_end|> ok"
    assert ours.encode(text) == theirs.encode(text)
    # a WordPiece tokenizer: the port names the feature instead of falling back
    from tokenizers import Tokenizer
    from tokenizers.models import WordPiece
    Tokenizer(WordPiece({"[UNK]": 0, "a": 1}, unk_token="[UNK]")).save(
        str(tmp_path / "tokenizer.json"))
    with pytest.raises(UnsupportedTokenizerError, match="WordPiece"):
        load_hf_tokenizer(str(tmp_path))


# -- the reference-format SFT checkpoints -------------------------------------------

def reference_state(hf_dirs, peft_wrapped=False):
    """A reference `DNALLMModel.state_dict()` built from the HF pair: the
    text model's q/v projections wrapped by PEFT (base_layer + lora_A/B
    with non-zero B), the encoder, a projection, and an optimizer entry that
    belongs to neither tower."""
    from bioreason_tpu_torch.utils.hf_import import load_hf_state_dict
    qwen, nt = hf_dirs
    rng = np.random.default_rng(7)
    out = {}
    for k, v in load_hf_state_dict(qwen).items():
        m = k.endswith(("q_proj.weight", "v_proj.weight")) and peft_wrapped
        pre = "text_model.base_model.model." if peft_wrapped else "text_model."
        if m:
            stem = k[:-len(".weight")]
            out[pre + stem + ".base_layer.weight"] = v.clone()
            out[pre + stem + ".lora_A.default.weight"] = torch.from_numpy(
                _w(rng, (4, v.shape[1])))
            out[pre + stem + ".lora_B.default.weight"] = torch.from_numpy(
                _w(rng, (v.shape[0], 4)))
        else:
            out[pre + k] = v.clone()
    for k, v in load_hf_state_dict(nt).items():
        out["dna_model." + k] = v.clone()
    out["dna_projection.weight"] = torch.from_numpy(_w(rng, (H, H)))
    out["dna_projection.bias"] = torch.from_numpy(_w(rng, (H,)))
    out["optimizer.step"] = torch.tensor(3)
    return out


@pytest.mark.parametrize("fmt", ["raw", "peft_wrapped", "lightning", "deepspeed", "dir"])
def test_reference_formats_load_as_jax_loads_them(tmp_path, hf_dirs, fmt):
    """Each container the reference writes, read by the port into a fusion
    model, equals JAX `load_reference_sft`'s tree (LoRA merged) through
    `from_jax_params`, bit for bit."""
    from bioreason_tpu.utils.ref_ckpt import load_reference_sft as j_load
    from bioreason_tpu_torch.utils import safetensors_io as S
    from bioreason_tpu_torch.utils.ref_ckpt import load_reference_sft
    qwen, nt = hf_dirs
    state = reference_state(hf_dirs, peft_wrapped=fmt != "raw")
    if fmt == "lightning":
        path = str(tmp_path / "ref.ckpt")
        torch.save({"state_dict": {f"_forward_module.model.{k}": v for k, v in state.items()},
                    "epoch": 1}, path)
    elif fmt == "deepspeed":
        path = str(tmp_path / "ref.pt")
        torch.save({"module": state}, path)
    elif fmt == "dir":
        path = str(tmp_path / "refdir")
        os.makedirs(path)
        S.save_file({k: v.contiguous() for k, v in state.items()},
                    os.path.join(path, "model.safetensors"))
    else:
        path = str(tmp_path / "ref.bin")
        torch.save(state, path)
    jcfg, params, _, _ = jax_fusion(qwen, nt)
    loaded = j_load(path, jcfg)
    cfg, model, _, _ = TP.load_pretrained_fusion(qwen, nt, 256, 64, dtype="float32",
                                                 device="cpu")
    assert load_reference_sft(path, model) == ["dna_model", "dna_projection", "text_model"]
    want = dict(from_jax_params({**params, **loaded}, cfg, device="cpu").named_parameters())
    for name, p in model.named_parameters():
        assert torch.equal(p, want[name]), name
    if fmt != "raw":                         # the LoRA delta was really merged
        base = dict(TP.load_pretrained_fusion(qwen, nt, 256, 64, dtype="float32",
                                              device="cpu")[1].named_parameters())
        assert not torch.equal(base["decoder.layers.0.attn.q.weight"],
                               want["decoder.layers.0.attn.q.weight"])


def test_peft_adapter_dir_merges_as_jax_does(tmp_path, hf_dirs):
    """A PEFT adapter directory (adapter_config.json with r / alpha, the
    adapter as safetensors) merged into the decoder: W += (alpha / r) B @ A,
    equal to JAX `apply_peft_adapter` bit for bit; a bare adapter directory
    given as a full checkpoint is refused."""
    from bioreason_tpu.utils.ref_ckpt import apply_peft_adapter as j_apply
    from bioreason_tpu_torch.utils import safetensors_io as S
    from bioreason_tpu_torch.utils.ref_ckpt import apply_peft_adapter, load_reference_sft
    qwen, nt = hf_dirs
    rng = np.random.default_rng(8)
    adapter = {}
    for i in range(LAYERS):
        for mod, (o, n) in (("self_attn.q_proj", (HEADS * HD, H)), ("mlp.down_proj", (H, I_DEC))):
            pre = f"base_model.model.model.layers.{i}.{mod}"
            adapter[f"{pre}.lora_A.weight"] = torch.from_numpy(_w(rng, (8, n)))
            adapter[f"{pre}.lora_B.weight"] = torch.from_numpy(_w(rng, (o, 8)))
    d = tmp_path / "adapter"
    d.mkdir()
    S.save_file(adapter, str(d / "adapter_model.safetensors"))
    (d / "adapter_config.json").write_text(json.dumps({"r": 8, "lora_alpha": 16}))
    jcfg, params, _, _ = jax_fusion(qwen, nt)
    jdec = j_apply(params["decoder"], str(d))
    cfg, model, _, _ = TP.load_pretrained_fusion(qwen, nt, 256, 64, dtype="float32",
                                                 device="cpu")
    apply_peft_adapter(model.decoder, str(d))
    want = dict(from_jax_params({**params, "decoder": jdec}, cfg, device="cpu")
                .decoder.named_parameters())
    for name, p in model.decoder.named_parameters():
        assert torch.equal(p, want[name]), name
    with pytest.raises(ValueError, match="adapter"):
        load_reference_sft(str(d), model)


def test_export_reference_sft_round_trips(tmp_path, hf_dirs):
    """`export_reference_sft` (plain and Lightning-prefixed) read back by
    `load_reference_sft` gives every parameter back bit for bit, and the JAX
    reader takes the same file."""
    from bioreason_tpu.utils.ref_ckpt import load_reference_sft as j_load
    from bioreason_tpu_torch.utils.ref_ckpt import export_reference_sft, load_reference_sft
    qwen, nt = hf_dirs
    _, model, _, _ = TP.load_pretrained_fusion(qwen, nt, 256, 64, dtype="float32", device="cpu")
    jcfg, _, _, _ = jax_fusion(qwen, nt)
    for lightning in (False, True):
        path = str(tmp_path / f"export{lightning}.pt")
        torch.save(export_reference_sft(model, lightning=lightning), path)
        _, other, _, _ = TP.load_pretrained_fusion(qwen, nt, 256, 64, seed=9, dtype="float32",
                                                   device="cpu")
        load_reference_sft(path, other)
        want = dict(model.named_parameters())
        for name, p in other.named_parameters():
            assert torch.equal(p, want[name]), name
        jt = j_load(path, jcfg)
        np.testing.assert_array_equal(jt["dna_projection"]["kernel"].T,
                                      want["dna_projection.weight"].detach().numpy())


# -- the variant-effect and LLM-only formatting -------------------------------------

@pytest.mark.parametrize("dataset_type", ["kegg", "variant_effect_coding",
                                          "variant_effect_non_snv"])
@pytest.mark.parametrize("llm_only", [False, True])
def test_load_items_formats_each_task_as_jax(tmp_path, dataset_type, llm_only):
    """`cli.common.load_items` (clean, truncate, split, chat-format) item for
    item against the JAX package's, for the three tasks with the DNA
    through the tower or pasted as text."""
    from bioreason_tpu_torch.cli.common import load_items
    data = None
    if dataset_type != "kegg":
        data = str(tmp_path / "data")
        os.makedirs(data)
        rows = variant_items(12, 3)
        if dataset_type == "variant_effect_non_snv":
            for r in rows:
                r["answer"] = "['frameshift_variant', 'stop_gained']"
        with open(os.path.join(data, "ve.jsonl"), "w") as f:
            f.write("\n".join(json.dumps(r) for r in rows))
    args = (dataset_type, data, 12, 10, 4)
    assert load_items(*args, llm_only=llm_only) == JCommon.load_items(*args, llm_only=llm_only)


# -- the whole slice: train_sft, reason and serve from HF directories ---------------

@pytest.fixture(scope="module")
def ve_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("ve")
    with open(d / "ve.jsonl", "w") as f:
        f.write("\n".join(json.dumps(r) for r in variant_items(16, 0)))
    return str(d)


CLI_BATCHES = 2


@pytest.fixture(scope="module")
def sft_run(hf_dirs, ve_data, tmp_path_factory):
    """`train_sft --hf_llm_dir --hf_dna_dir --dataset_type
    variant_effect_coding` for 2 steps at fp32 (LoRA dropout 0), and the
    model it started from."""
    from bioreason_tpu_torch.cli import train_sft
    root = str(tmp_path_factory.mktemp("sft"))
    qwen, nt = hf_dirs
    argv = ["--hf_llm_dir", qwen, "--hf_dna_dir", nt, "--dataset_type",
            "variant_effect_coding", "--data_dir", ve_data, "--device", "cpu", "--dtype",
            "float32", "--max_steps", str(CLI_BATCHES), "--batch_size", "2",
            "--max_length_dna", "64", "--max_length_text", "256", "--lora_r", "4",
            "--lora_alpha", "8", "--lora_dropout", "0", "--learning_rate", "1e-2",
            "--seed", "5", "--checkpoint_dir", root]
    trainer = train_sft.main(argv)
    return root, trainer, argv


def jax_cli_twin(qwen, nt, ve_data, lora_a_items, proj):
    """The JAX SFTTrainer on the CLI's batches from JAX's own import, its
    adapters' A and the projection set to the port CLI's draws."""
    from bioreason_tpu.train import sft as JS
    from bioreason_tpu.train.dataflow import batch_iterator as j_batches
    jcfg, params, tok, dna_tok = jax_fusion(qwen, nt)
    params = dict(params)
    params["dna_projection"] = {"kernel": np.asarray(proj[0]), "bias": np.asarray(proj[1])}
    lora_a = dict(lora_a_items)
    real_attach = JS.attach_lora

    def attach(rng, tree, cfg):
        out = flat(jax.tree.map(np.asarray, real_attach(rng, tree, cfg)))
        out.update({k: np.asarray(v) for k, v in lora_a.items()})
        return unflat(out)
    JS.attach_lora = attach
    try:
        jsft = JC.SFTConfig(batch_size=2, max_length_dna=64, max_length_text=256, bucket=128,
                            optim=JC.OptimConfig(learning_rate=1e-2, total_steps=CLI_BATCHES),
                            lora=JC.LoRAConfig(r=4, alpha=8, dropout=0.0), seed=5)
        trainer = JTrainer(jcfg, jsft, params=params,
                           mesh=make_mesh(JC.MeshConfig(data=1), devices=jax.devices()[:1]))
    finally:
        JS.attach_lora = real_attach
    train, _, _ = JCommon.load_items("variant_effect_coding", ve_data, 64, 1024, 5)
    collate = functools.partial(JD.sft_collate, processor=JProc(tok, dna_tok),
                                max_length_text=256, max_length_dna=64, bucket=128)
    batches = j_batches(train, collate, 2, seed=5, epochs=1)
    return [trainer.train_step(next(batches))["loss"] for _ in range(CLI_BATCHES)]


def test_train_sft_cli_from_hf_dirs_matches_jax(hf_dirs, ve_data, sft_run):
    """Two CLI steps from the HF pair on the coding variant-effect task:
    the losses of the JAX trainer fed the same batches from JAX's own
    import, with the port's draws of the adapters' A and the projection, at
    1e-5; the sft_final records the pretrained base."""
    from bioreason_tpu_torch.train.checkpoint import load_checkpoint
    from bioreason_tpu_torch.utils.pretrained import load_pretrained_fusion
    from bioreason_tpu_torch.train.lora import attach_lora
    root, trainer, _ = sft_run
    qwen, nt = hf_dirs
    # the port CLI's initial draws, made again as the trainer makes them
    _, init, _, _ = load_pretrained_fusion(qwen, nt, 256, 64, seed=5, dtype="float32",
                                           device="cpu")
    attach_lora(init, TC.LoRAConfig(r=4, alpha=8), torch.Generator().manual_seed(6))
    lora_a = []
    for i, layer in enumerate(init.decoder.layers):
        for grp, names in (("attn", "qkvo"), ("mlp", ("gate", "up", "down"))):
            for n in names:
                lin = getattr(getattr(layer, grp), n)
                lora_a.append((f"decoder/layers/{grp}/{n}/lora_a", i, lin.lora_a.detach().numpy()))
    stacked = {}
    for k, i, a in lora_a:
        stacked.setdefault(k, []).append(a)
    items = tuple((k, np.stack(v)) for k, v in stacked.items())
    proj = (init.dna_projection.weight.detach().numpy().T.copy(),
            init.dna_projection.bias.detach().numpy().copy())
    want = jax_cli_twin(qwen, nt, ve_data, items, proj)
    got = [m["loss"] for m in trainer.history]
    assert got == pytest.approx(want, rel=1e-5)
    meta = load_checkpoint(os.path.join(root, "sft_final"))["metadata"]
    assert meta["hf_llm_dir"] == os.path.abspath(qwen) and meta["evo2_dir"] is None
    assert sorted(os.path.basename(f) for f in meta["base_files"]) == [
        "config.json", "config.json", "model.safetensors", "model.safetensors"]


def test_sft_final_rebuilds_from_the_base_and_refuses_a_changed_or_missing_one(
        tmp_path, hf_dirs, sft_run):
    """`load_sft_model` rebuilds the SFT model of a pretrained base from
    the recorded directories parameter for parameter; a base whose weights
    file was rewritten, or whose directory is gone, is refused and never
    replaced by a seeded one."""
    from bioreason_tpu_torch.train.checkpoint import load_sft_model
    root, trainer, _ = sft_run
    path = os.path.join(root, "sft_final")
    model = load_sft_model(path, trainer.fusion_cfg, 0, "ignored", "ignored", device="cpu")
    want = dict(trainer.model.named_parameters())
    for name, p in model.named_parameters():
        assert p.dtype == want[name].dtype and torch.equal(p, want[name]), name
    # a copy of the run whose base moves away
    qwen, nt = hf_dirs
    base = tmp_path / "base"
    shutil.copytree(qwen, base / "qwen3")
    shutil.copytree(nt, base / "nt")
    state = torch.load(os.path.join(path, "state.pt"), weights_only=True)
    meta = state["metadata"]
    meta.update(TP.base_record(str(base / "qwen3"), str(base / "nt")))
    moved = tmp_path / "moved_final"
    moved.mkdir()
    torch.save(state, moved / "state.pt")
    load_sft_model(str(moved), trainer.fusion_cfg, 0, "", "", device="cpu")
    st = base / "nt" / "model.safetensors"
    tensors = safetensors_np.load_file(str(st))
    tensors["esm.encoder.layer.0.LayerNorm.bias"] = np.zeros((H + 1,), np.float32)
    safetensors_np.save_file(tensors, str(st))
    with pytest.raises(ValueError, match="changed"):
        load_sft_model(str(moved), trainer.fusion_cfg, 0, "", "", device="cpu")
    shutil.rmtree(base / "nt")
    with pytest.raises(FileNotFoundError, match="gone"):
        load_sft_model(str(moved), trainer.fusion_cfg, 0, "", "", device="cpu")
    from bioreason_tpu_torch import serve
    with pytest.raises(FileNotFoundError, match="gone"):
        serve.build_server(checkpoint=str(moved), device="cpu")


def test_reason_cli_from_a_reference_checkpoint(tmp_path, hf_dirs, ve_data, sft_run):
    """`reason --hf_llm_dir --hf_dna_dir --sft_checkpoint <file>` on a
    reference `.pt` exported from the SFT model: it loads the merged SFT
    model bit for bit, attaches fresh adapters and runs 2 finite GRPO steps
    on the variant-effect prompts; the port's own sft_final of another
    base is refused."""
    from bioreason_tpu_torch.cli import reason
    from bioreason_tpu_torch.train.lora import merge_lora
    from bioreason_tpu_torch.utils.ref_ckpt import export_reference_sft
    root, trainer, _ = sft_run
    qwen, nt = hf_dirs
    merged = merge_lora(__import__("copy").deepcopy(trainer.model))
    ref = str(tmp_path / "reference.pt")
    torch.save(export_reference_sft(merged), ref)
    argv = ["--hf_llm_dir", qwen, "--hf_dna_dir", nt, "--device", "cpu", "--dtype", "float32",
            "--num_generations", "2", "--batch_size", "4", "--max_steps", "2",
            "--max_completion_length", "8", "--max_length_dna", "64", "--seed", "5",
            "--dataset_type", "variant_effect_coding", "--data_dir", ve_data,
            "--checkpoint_dir", str(tmp_path / "ck"), "--log_dir", str(tmp_path / "logs")]
    grpo = reason.main(argv + ["--sft_checkpoint", ref])
    assert grpo.step_count == 2
    assert all(math.isfinite(m["loss"]) and math.isfinite(m["kl"])
               for m in grpo.metrics_history)
    want = dict(merged.named_parameters())
    ref_model = dict(grpo.ref_model.named_parameters())
    for name, p in ref_model.items():
        if name.startswith("dna_projection") or ".lora_" in name:
            continue
        assert torch.equal(p.float(), want[name].float()), name
    other = tmp_path / "other_qwen"
    shutil.copytree(qwen, other)
    with pytest.raises(ValueError, match="another base"):
        reason.main([*argv[:1], str(other), *argv[2:], "--sft_checkpoint",
                     os.path.join(root, "sft_final")])


def jax_greedy(qwen, nt, tree_items, prompt_batch_items, max_new):
    from bioreason_tpu.generate.engine import GenerationEngine as JEngine
    from bioreason_tpu.train.lora import merge_lora as j_merge
    jcfg, _, tok, _ = jax_fusion(qwen, nt)
    tree = unflat(dict(tree_items))
    batch = dict(prompt_batch_items)
    engine = JEngine(jcfg, eos_token_id=tok.eos_token_id)
    ids, mask = engine.generate(j_merge(jax.tree.map(jax.numpy.asarray, tree)),
                                batch["input_ids"], batch["attention_mask"],
                                batch["dna_input_ids"], batch["dna_attention_mask"],
                                max_new_tokens=max_new, greedy=True)
    return np.asarray(ids), np.asarray(mask)


def test_serve_checkpoint_greedy_matches_the_jax_engine(hf_dirs, sft_run):
    """`serve --checkpoint <sft_final>` (the base rebuilt from its HF
    directories, frozen weights stored as the trainer stored them, LoRA
    merged) answers greedy requests token for token as the JAX engine does
    on the same tree: the base as the JAX trainer stores it (its ndim >= 2
    rule), the trained adapters and projection, merged by JAX `merge_lora`."""
    from bioreason_tpu_torch import serve
    root, trainer, _ = sft_run
    qwen, nt = hf_dirs
    server = serve.build_server(checkpoint=os.path.join(root, "sft_final"), device="cpu",
                                max_length_dna=64, max_new_tokens=12, greedy_default=True)
    items = [{"question": f"Is variant {k} pathogenic?", "answer": "",
              "reference_sequence": "ACGTTGCA" * (k + 2),
              "variant_sequence": "ACGTAGCA" * (k + 2)} for k in range(3)]
    batch = serve.prepare_batch(server.processor, server.cfg, items)
    _, params, _, _ = jax_fusion(qwen, nt)
    tree = {k: (v.astype(jax.numpy.bfloat16) if (v.dtype == np.float32 and v.ndim >= 2)
                else v) for k, v in flat(params).items()}
    for name, p in trainer.trainable_state().items():
        parts = name.split(".")
        if parts[0] == "dna_projection":
            v = p.detach().numpy()
            tree[f"dna_projection/{'kernel' if parts[1] == 'weight' else 'bias'}"] = (
                v.T if parts[1] == "weight" else v)
    for leaf in ("lora_a", "lora_b"):
        for grp, names in (("attn", "qkvo"), ("mlp", ("gate", "up", "down"))):
            for n in names:
                tree[f"decoder/layers/{grp}/{n}/{leaf}"] = np.stack(
                    [getattr(getattr(layer, grp), n).__getattr__(leaf).detach().numpy()
                     for layer in trainer.model.decoder.layers])
                tree[f"decoder/layers/{grp}/{n}/lora_scale"] = np.full((LAYERS,), 2.0,
                                                                        np.float32)
    keys = ("input_ids", "attention_mask", "dna_input_ids", "dna_attention_mask")
    want_ids, want_mask = jax_greedy(qwen, nt, tuple(tree.items()),
                                     tuple(zip(keys, batch)), 12)
    got_ids, got_mask = server.engine.generate(server.model, *batch, max_new_tokens=12,
                                               greedy=True)
    np.testing.assert_array_equal(got_mask, want_mask)
    np.testing.assert_array_equal(got_ids[got_mask.astype(bool)],
                                  want_ids[want_mask.astype(bool)])
    server.start()
    try:
        out = server.generate(items[0], max_new_tokens=12)
    finally:
        server.stop()
    text = server.processor.text_tokenizer.decode(
        got_ids[0][got_mask[0].astype(bool)], skip_special_tokens=True)
    assert out["completion"] == text


def test_train_sft_cli_with_the_evo2_tower_from_a_directory(tmp_path, hf_dirs):
    """`train_sft --hf_llm_dir --evo2_dir` over a directory holding the
    committed vortex fixture: 2 finite steps, the tower frozen in bf16
    filter storage, its base recorded with the `.pt` file's fingerprint."""
    from bioreason_tpu_torch.cli import train_sft
    from bioreason_tpu_torch.train.checkpoint import load_checkpoint
    evo2 = tmp_path / "evo2"
    evo2.mkdir()
    shutil.copy(os.path.join(os.path.dirname(__file__), "assets", "evo2_tiny.pt"), evo2)
    trainer = train_sft.main(["--hf_llm_dir", hf_dirs[0], "--evo2_dir", str(evo2),
                              "--device", "cpu", "--dtype", "float32", "--max_steps", "2",
                              "--batch_size", "2", "--n_synthetic", "16",
                              "--max_length_dna", "64", "--checkpoint_dir",
                              str(tmp_path / "ck")])
    assert trainer.fusion_cfg.encoder_kind == "evo2"
    assert len(trainer.history) == 2 and all(math.isfinite(m["loss"])
                                             for m in trainer.history)
    meta = load_checkpoint(str(tmp_path / "ck" / "sft_final"))["metadata"]
    assert meta["evo2_dir"] == str(evo2) and any(f.endswith("evo2_tiny.pt")
                                                 for f in meta["base_files"])


def test_topk_keeper_keeps_the_set_jax_keeps(tmp_path):
    """The same sequence of values (a NaN among them) leaves the same kept
    steps and best path in both packages' TopKKeeper, and a new keeper over
    the same root adopts the ranking."""
    from bioreason_tpu.train.checkpoint import TopKKeeper as JKeeper
    from bioreason_tpu_torch.train.checkpoint import TopKKeeper
    values = [3.0, 2.5, float("nan"), 2.7, 1.0, 4.0, 1.5, 1.5]
    kept = []
    for cls, name in ((JKeeper, "jax"), (TopKKeeper, "port")):
        keeper = cls(str(tmp_path / name), k=2)
        saved = [keeper.update(v, lambda p: os.makedirs(p), step)
                 for step, v in enumerate(values)]
        kept.append(([s is not None for s in saved], sorted(os.listdir(tmp_path / name)),
                     os.path.basename(keeper.best_path())))
        again = cls(str(tmp_path / name), k=2)
        assert again.best_path() == keeper.best_path()
    assert kept[0] == kept[1]
    assert kept[1][1] == ["best-step4", "best-step6", "index.json"]


def test_profile_dir_writes_a_trace(tmp_path):
    from bioreason_tpu_torch.utils.profiling import StepClock, annotate, trace
    clock = StepClock(window=3)
    with trace(str(tmp_path)):
        for _ in range(4):
            with clock, annotate("work"):
                torch.ones(8).sum()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "work" for e in events)
    assert len(clock.samples) == 3 and set(clock.stats()) == {
        "step_time_mean", "step_time_p50", "step_time_p90"}
